"""The port's whole main path on the CPU against the reference:
`quantfc` witness -> `compile` -> `ProofSession.prove` -> `encode_proof`
-> `verify_bytes`.

The port's proof bytes must hash to the reference's recorded digests
(`GOLDEN_SHA256` of tests/test_proofio.py for the uniform 2x4 MLP;
digests recorded from `repro.core.pipeline` for a residual MLP and the
16-8-4-2 pyramid).  Equal bytes make the two verifiers' inputs the
same: the port's `verify_bytes` accepting these bytes is the port
accepting the reference's proofs, and the reference's own tests
(tests/test_proofio.py) accept the goldens.  The reference proves and
verifies a new graph in minutes of XLA compiles on a CPU, hence
recorded digests instead of re-running it here."""
import dataclasses
import functools
import hashlib
import struct

import numpy as np
import pytest
import torch

from repro.core import quantfc as rq
from repro.core.pipeline import GraphBuilder as RBuilder
from repro.core.pipeline import compile as r_compile
from repro.core.pipeline.proofio import encode_vk as r_encode_vk

from repro_torch.core.quantfc import (QuantConfig,
                                      synthetic_sgd_trajectory_widths)
from repro_torch.core.pipeline import (GraphBuilder, VerifyingKey,
                                       build_fcnn_graph, compile,
                                       decode_proof, encode_proof,
                                       graph_skips, graph_widths,
                                       prove_session, verify_bytes)
from repro_torch.core.pipeline.proofio import _SECTIONS
from repro_torch.interop import from_reference

QC = QuantConfig(q_bits=16, r_bits=4)

# the reference's recorded v3 encodings (tests/test_proofio.py)
GOLDEN_SHA256 = {
    1: "a538160f1da619bd39439420f78d24af9089dd1eacd770f3ce24d76dd80c2422",
    2: "17e8be25e9320abb55694a27615bf0093a7c0c08e290f2e11856a8d4f09b08f6",
}
# recorded from repro.core.pipeline.prove_session on the graphs below
# (the reference's verify_bytes accepted the port's bytes of both)
REFERENCE_SHA256 = {
    "residual":
        "220f057bd68e159a9ca1c07df4a8dae9b9c48841273be1e2bb5571a15d1337ca",
    "pyramid":
        "99f9328efd661006605d3dd12bf40cd66c9a206ee1f31b6c8ce9fa71de62426a",
}


@pytest.fixture(autouse=True, scope="module")
def _reference_without_disk_executables():
    """Run the reference's wrapped programs through plain `jax.jit` here:
    its on-disk executable cache is keyed without the device count, so
    an entry written by a worker that imported benchmarks/perf.py (512
    forced host devices) fails to load in a one-device worker, and this
    file must neither read nor write such entries."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKDL_EXEC_MODE", "off")
        yield


def _uniform_graph(builder):
    return builder(batch=2).input(4).dense(4).relu().dense(4).relu() \
        .output()


def _graphs():
    res = GraphBuilder(batch=2).input(4).dense(4).relu().dense(4).relu() \
        .residual(to=1).dense(4).relu().output()
    return {"residual": (res, 3),
            "pyramid": (build_fcnn_graph((16, 8, 4, 2), 2), 5)}


def _prove(graph, T, seed):
    pk, vk = compile(graph, QC, n_steps=T, device="cpu")
    wits = synthetic_sgd_trajectory_widths(
        T, graph_widths(graph), 2, QC, seed=seed, skips=graph_skips(graph),
        device="cpu")
    return vk, encode_proof(prove_session(pk, wits,
                                          np.random.default_rng(seed)))


@functools.lru_cache(maxsize=None)
def _uniform(T):
    vk, raw = _prove(_uniform_graph(GraphBuilder), T, 7)
    return T, vk, raw


@pytest.fixture(scope="module", params=[1, 2], ids=["T1", "T2"])
def uniform(request):
    return _uniform(request.param)


def test_golden_serialized_bytes(uniform):
    T, _, raw = uniform
    assert hashlib.sha256(raw).hexdigest() == GOLDEN_SHA256[T]


def test_port_verifier_accepts_reference_bytes(uniform):
    """The bytes equal the reference's golden proof, so this is the port
    verifying the reference's proof; decode/encode is canonical."""
    _, vk, raw = uniform
    assert verify_bytes(vk, raw)
    assert encode_proof(decode_proof(raw)) == raw


def _section_spans(raw):
    pos, spans = 6, []
    for name in _SECTIONS:
        (length,) = struct.unpack("<I", raw[pos + 1: pos + 5])
        spans.append((name, pos + 5, length))
        pos += 5 + length
    assert pos == len(raw)
    return spans


def test_tamper_each_section_rejects():
    _, vk, raw = _uniform(1)
    for name, start, length in _section_spans(raw):
        bad = bytearray(raw)
        bad[start + length // 2] ^= 0x01
        trace = []
        assert not verify_bytes(vk, bytes(bad), trace=trace), name
        assert trace, name


def test_vk_bytes_match_reference():
    _, vk = compile(_uniform_graph(GraphBuilder), QC, n_steps=2,
                    device="cpu")
    _, rvk = r_compile(_uniform_graph(RBuilder), rq.QuantConfig(16, 4),
                       n_steps=2)
    assert vk.to_bytes() == r_encode_vk(rvk)
    back = VerifyingKey.from_bytes(vk.to_bytes(), device="cpu")
    assert back.cfg == vk.cfg


def _numpy_fields(wit) -> dict:
    out = {}
    for f in dataclasses.fields(wit):
        v = getattr(wit, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.numpy()
        elif isinstance(v, list):
            out[f.name] = [t.numpy() for t in v]
    return out


@pytest.mark.parametrize("name", ["residual", "pyramid"])
def test_witness_matches_reference(name):
    graph, seed = _graphs()[name]
    widths, skips = graph_widths(graph), graph_skips(graph)
    ref = rq.synthetic_sgd_trajectory_widths(
        2, widths, 2, rq.QuantConfig(16, 4), seed=seed, skips=skips)
    port = synthetic_sgd_trajectory_widths(2, widths, 2, QC, seed=seed,
                                           skips=skips, device="cpu")
    for r, p in zip(ref, port):
        fields = _numpy_fields(p)
        for key in ("x", "y"):
            np.testing.assert_array_equal(fields[key], getattr(r, key))
        for key in ("w", "z", "zpp", "b", "rz", "a", "gz", "ga", "gap",
                    "rga", "gw"):
            for got, want in zip(fields[key], getattr(r, key)):
                np.testing.assert_array_equal(got, want)
        carried = from_reference(r, "cpu")
        assert torch.equal(carried.gw[0], p.gw[0]) and carried.skips == skips


@pytest.mark.parametrize("name", ["residual", "pyramid"])
def test_graphs_prove_like_reference_and_verify(name):
    graph, seed = _graphs()[name]
    vk, raw = _prove(graph, 1, seed)
    assert hashlib.sha256(raw).hexdigest() == REFERENCE_SHA256[name]
    assert verify_bytes(vk, raw)
    bad = bytearray(raw)
    bad[len(raw) // 2] ^= 0x40
    assert not verify_bytes(vk, bytes(bad))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        compile(_uniform_graph(GraphBuilder), QC)
