"""bfloat16 leaves in the port's checkpoints, against the reference's.

The reference writes a bfloat16 leaf through ``ml_dtypes``: ``np.save``
of the array gives a ``'<V2'`` ``.npy`` file of the raw 2-byte words,
and ``manifest.json`` says ``"dtype": "bfloat16"``.  The port writes the
same bytes without ``ml_dtypes`` and restores them bit for bit, from
its own checkpoints and from the reference's.  (The reference's own
``restore`` refuses those files: ``jax.device_put`` of a ``|V2`` array
raises ``TypeError``; ROADMAP.md queue 3.)
"""
import json
import os

import ml_dtypes
import numpy as np
import torch

from repro.train import checkpoint as ref_checkpoint
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.train import checkpoint
from repro_torch.tree import tree_leaves


def _bf16(seed: int, shape=(3, 5)) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    t = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    t = t.to(torch.bfloat16)
    t.view(torch.int16)[0, :3] = torch.tensor([0x7F80, -0x80, 0x0001],
                                              dtype=torch.int16)  # inf -0 den
    return t


def _ref_array(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def test_bfloat16_leaf_bytes_equal_the_reference(tmp_path):
    t = _bf16(0)
    state = {"mu": {"w": t}, "step": torch.tensor(3, dtype=torch.int32)}
    ref_state = {"mu": {"w": _ref_array(t)}, "step": np.int32(3)}
    port_dir = checkpoint.save(str(tmp_path / "port"), 1, state)
    ref_dir = ref_checkpoint.save(str(tmp_path / "ref"), 1, ref_state)
    for name in ("mu__w.npy", "step.npy"):
        with open(os.path.join(port_dir, name), "rb") as f:
            got = f.read()
        with open(os.path.join(ref_dir, name), "rb") as f:
            assert got == f.read(), name
    for d in (port_dir, ref_dir):
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        assert man["leaves"]["mu__w"] == {"shape": [3, 5],
                                          "dtype": "bfloat16"}


def test_bfloat16_restores_bit_for_bit_from_either_package(tmp_path):
    t = _bf16(1, (4, 2, 3))
    template = {"mu": {"w": torch.zeros((4, 2, 3), dtype=torch.bfloat16)}}
    checkpoint.save(str(tmp_path / "port"), 2, {"mu": {"w": t}})
    ref_checkpoint.save(str(tmp_path / "ref"), 2,
                        {"mu": {"w": _ref_array(t)}})
    for d in ("port", "ref"):
        got = checkpoint.restore(str(tmp_path / d), 2, template,
                                 device="cpu")["mu"]["w"]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), t.view(torch.int16)), d


def test_default_opt_cfg_bfloat16_moments_save_and_restore(tmp_path):
    """The moments `default_opt_cfg` picks above 100B parameters
    (grok-1-314b), on the grok smoke config, after one update."""
    opt_cfg = steps.default_opt_cfg(registry.get_config("grok1_314b"))
    assert opt_cfg.state_dtype == "bfloat16"
    cfg = registry.smoke_config("grok1_314b")
    state, specs = ttrain.build_state(cfg, opt_cfg, device="cpu")
    rng = np.random.default_rng(2)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)),
                                dtype=torch.int32)
             for k in ("tokens", "labels")}
    state, _ = steps.build_train_step(cfg, opt_cfg)(state, batch)
    assert state["opt"]["mu"]["embed"].dtype == torch.bfloat16
    path = checkpoint.save(str(tmp_path), 1, state)
    back = checkpoint.restore(str(tmp_path), 1, specs, device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {v["dtype"] for v in json.load(f)["leaves"].values()}
    assert dtypes == {"bfloat16", "float32", "int32"}
