"""The port's preflight witness validation (`repro_torch.launch.preflight`)
against the reference's (`repro.launch.preflight`).

Each perturbation of tests/test_preflight.py is applied to the same
witness in both packages (the reference's numpy arrays, the port's
tensors, both from the seeded synthetic stream): the port must raise
the reference's error class with the reference's message, and accept
what the reference accepts."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.core import quantfc as rq
from repro.core.pipeline import build_fcnn_graph as r_build_fcnn_graph
from repro.core.pipeline.config import PipelineConfig as RPipelineConfig
from repro.launch import preflight as ref_preflight

from repro_torch.core import quantfc as tq
from repro_torch.core.pipeline import build_fcnn_graph
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.launch.preflight import (WitnessDtypeError, WitnessQuantError,
                                          WitnessRangeError, WitnessShapeError,
                                          WitnessStepError,
                                          WitnessTopologyError,
                                          WitnessValidationError,
                                          check_step_monotonic,
                                          validate_witness)

WIDTHS = (4, 4, 4)
B = 2
Q, R = 16, 4
LISTS = ("w", "z", "zpp", "b", "rz", "a", "gz", "ga", "gap", "rga", "gw")


@pytest.fixture(scope="module")
def cfgs():
    ref = RPipelineConfig.from_graph(r_build_fcnn_graph(WIDTHS, batch=B),
                                     q_bits=Q, r_bits=R, n_steps=1)
    port = PipelineConfig.from_graph(build_fcnn_graph(WIDTHS, batch=B),
                                     q_bits=Q, r_bits=R, n_steps=1)
    return ref, port


def _wits():
    """Fresh, independently mutable copies of the same step witness."""
    ref = rq.synthetic_sgd_trajectory_widths(1, WIDTHS, B,
                                             rq.QuantConfig(Q, R), seed=9)[0]
    ref = dataclasses.replace(
        ref, x=ref.x.copy(), y=ref.y.copy(), skips=dict(ref.skips),
        **{f: [a.copy() for a in getattr(ref, f)] for f in LISTS})
    port = tq.synthetic_sgd_trajectory_widths(1, WIDTHS, B,
                                              tq.QuantConfig(Q, R), seed=9,
                                              device="cpu")[0]
    port = dataclasses.replace(
        port, x=port.x.clone(), y=port.y.clone(), skips=dict(port.skips),
        **{f: [a.clone() for a in getattr(port, f)] for f in LISTS})
    return ref, port


def _int32(a):
    return a.astype(np.int32) if isinstance(a, np.ndarray) \
        else a.to(torch.int32)


# name -> perturbation(wit, quant_config_class) -> perturbed witness
PERTURBATIONS = {
    "valid": lambda w, qc: w,
    "quant_mismatch": lambda w, qc: dataclasses.replace(w, cfg=qc(8, 2)),
    "layer_count": lambda w, qc: dataclasses.replace(w, w=w.w[:1]),
    "tensor_shape": lambda w, qc: dataclasses.replace(
        w, w=[w.w[0][:, :3]] + w.w[1:]),
    "batch": lambda w, qc: dataclasses.replace(w, x=w.x[:1]),
    "dtype": lambda w, qc: dataclasses.replace(w, x=_int32(w.x)),
    "topology": lambda w, qc: dataclasses.replace(w, skips={2: 1}),
}


def _poke(field, value=None, delta=None):
    def perturb(w, qc):
        t = getattr(w, field)[0]
        t[0, 0] = value if delta is None else t[0, 0] + delta
        return w
    return perturb


PERTURBATIONS.update({
    "zpp_out_of_range": _poke("zpp", value=1 << (Q - 1)),
    "bit_plane_not_binary": _poke("b", value=2),
    "remainder_out_of_range": _poke("rz", value=1 << R),
    "zkrelu_decomposition": _poke("z", delta=1),
    "grad_rescale_decomposition": _poke("ga", delta=1),
})


def _outcome(validate, cfg, wit):
    try:
        validate(cfg, wit)
    except ValueError as exc:
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("name", list(PERTURBATIONS))
def test_same_class_and_message_as_reference(cfgs, name):
    ref_cfg, port_cfg = cfgs
    ref_wit, port_wit = _wits()
    want = _outcome(ref_preflight.validate_witness, ref_cfg,
                    PERTURBATIONS[name](ref_wit, rq.QuantConfig))
    got = _outcome(validate_witness, port_cfg,
                   PERTURBATIONS[name](port_wit, tq.QuantConfig))
    assert got == want
    assert (want is None) == (name == "valid")


def test_every_error_is_a_validation_and_value_error():
    for cls in (WitnessQuantError, WitnessShapeError, WitnessDtypeError,
                WitnessTopologyError, WitnessRangeError, WitnessStepError):
        assert issubclass(cls, WitnessValidationError)
        assert issubclass(cls, ValueError)
        assert issubclass(getattr(ref_preflight, cls.__name__), ValueError)


def test_step_monotonic_contract():
    assert check_step_monotonic("t", 5, None) == 5
    assert check_step_monotonic("t", 5, 5) == 5
    for bad in (4, 7):
        with pytest.raises(WitnessStepError) as got:
            check_step_monotonic("t", 5, bad)
        with pytest.raises(ref_preflight.WitnessStepError) as want:
            ref_preflight.check_step_monotonic("t", 5, bad)
        assert str(got.value) == str(want.value)


def test_validation_cheaper_than_a_prove(cfgs):
    """Preflight runs on every submit: elementwise, no group ops."""
    _, port_cfg = cfgs
    _, wit = _wits()
    t0 = time.perf_counter()
    for _ in range(20):
        validate_witness(port_cfg, wit)
    assert (time.perf_counter() - t0) / 20 < 0.05
