"""The port's LM training path against the reference, on the CPU.

* One AdamW update (`train.optim`) and each gradient compression mode
  (`train.compression`, int8 blocks and top-k with error feedback, two
  rounds) against the reference's on the same trees; top-k inputs are
  checked to have no ties at the threshold.  Tolerance: rtol 1e-6 (the
  same float32 operations in the same order).
* `repro_torch.launch.train.main(... --device cpu)` at the qwen3 smoke
  config in float32 against `repro.launch.train.main` with the same
  flags (both registries bound to that smoke config): the reference
  writes a checkpoint every step, the port resumes from the reference's
  step-1 checkpoint (the layouts are the same), and both then take
  steps 2 and 3: the port's losses equal the reference's printed ones
  (4 decimals) and its step-3 checkpoint equals the reference's within
  1e-5 of each leaf's largest entry.
* A ``--fail-at`` run resumes at the step after its last checkpoint and
  reproduces the uninterrupted run's losses exactly.

The reference runs with ``ZKDL_EXEC_MODE=off`` (no on-disk executables).
"""
import dataclasses
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.train import compression as rcomp
from repro.train import optim as roptim
from repro_torch.configs import registry as treg
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.train import compression as tcomp
from repro_torch.train import optim as toptim
from repro_torch.tree import tree_leaves, tree_map

SMOKE = ["--arch", "qwen3-0.6b", "--seq", "32", "--global-batch", "2",
         "--log-every", "1"]


@pytest.fixture(autouse=True, scope="module")
def _reference_without_disk_executables():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKDL_EXEC_MODE", "off")
        yield


def _tree(rng, scale=1.0):
    return {"a": {"w": (rng.normal(size=(37, 5)) * scale).astype(np.float32)},
            "b": (rng.normal(size=(300,)) * scale).astype(np.float32),
            "c": (rng.normal(size=(2, 3, 4)) * scale).astype(np.float32)}


def _np(tree):
    return tree_map(lambda t: np.asarray(t, np.float32), tree)


def _t(tree):
    return tree_map(torch.as_tensor, tree)


def _close(got, ref, rtol=1e-6):
    for g, r in zip(tree_leaves(got), tree_leaves(ref)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(r, np.float32), rtol=rtol,
                                   atol=1e-30)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), _tree(rng, 0.5)
    rcfg = roptim.AdamWConfig(grad_clip=clip, warmup_steps=3)
    tcfg = toptim.AdamWConfig(grad_clip=clip, warmup_steps=3)
    rstate = roptim.init_opt_state(params, rcfg)
    tstate = toptim.init_opt_state(_t(params), tcfg)
    rp, tp = params, _t(params)
    for _ in range(2):                              # bias correction moves
        rp, rstate, rm = roptim.apply_updates(rcfg, rp, grads, rstate)
        tp, tstate, tm = toptim.apply_updates(tcfg, tp, _t(grads), tstate)
    _close(tp, rp)
    _close(tstate["mu"], rstate["mu"])
    _close(tstate["nu"], rstate["nu"])
    assert int(tstate["step"]) == int(rstate["step"]) == 2
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-6)
    half = toptim.init_opt_state(_t(params),
                                 toptim.AdamWConfig(state_dtype="bfloat16"))
    assert half["mu"]["a"]["w"].dtype == torch.bfloat16
    assert tstate["mu"]["a"]["w"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_compression_matches_reference(mode):
    rng = np.random.default_rng(2)
    rcfg = rcomp.CompressionConfig(mode=mode, block=64, topk_frac=0.05)
    tcfg = tcomp.CompressionConfig(mode=mode, block=64, topk_frac=0.05)
    params = _tree(rng)
    rres, tres = rcomp.init_residuals(params), tcomp.init_residuals(
        _t(params))
    for _ in range(2):                        # the second round adds back
        grads = _tree(rng)
        if mode == "topk":
            for g, r in zip(tree_leaves(grads), tree_leaves(
                    _np(rres))):
                a = np.sort(np.abs(g + r).ravel())
                k = max(1, int(a.size * 0.05))
                assert a[-k] != a[-k - 1]           # no tie at the threshold
        rout, rres = rcomp.compress_grads(rcfg, grads, rres)
        tout, tres = tcomp.compress_grads(tcfg, _t(grads), tres)
        _close(tout, rout)
        _close(tres, rres)
    assert tcomp.wire_bytes_per_param(tcfg) == \
        rcomp.wire_bytes_per_param(rcfg)
    none = tcomp.CompressionConfig()
    same, _ = tcomp.compress_grads(none, _t(grads), tres)
    _close(same, grads, rtol=0)


def _losses(text):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"\[train\] step (\d+) loss ([-\d.]+)", text)}


def test_smoke_trainer_matches_reference_trainer(tmp_path, capsys,
                                                 monkeypatch):
    from repro.launch import train as rtrain

    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    monkeypatch.setattr(rreg, "get_config", lambda name, **kw:
                        dataclasses.replace(rreg.smoke_config(name),
                                            dtype="float32"))
    monkeypatch.setattr(treg, "get_config", lambda name, **kw:
                        dataclasses.replace(treg.smoke_config(name),
                                            dtype="float32"))
    assert rtrain.main(SMOKE + ["--steps", "4", "--ckpt-dir", ref_dir,
                                "--ckpt-every", "1"]) == 0
    ref_losses = _losses(capsys.readouterr().out)
    assert sorted(ref_losses) == [0, 1, 2, 3]
    os.makedirs(port_dir)
    shutil.copytree(os.path.join(ref_dir, "step_00000001"),
                    os.path.join(port_dir, "step_00000001"))
    assert ttrain.main(SMOKE + [
        "--device", "cpu", "--steps", "4",
        "--ckpt-dir", port_dir, "--ckpt-every", "1"]) == 0
    port_losses = _losses(capsys.readouterr().out)
    assert sorted(port_losses) == [2, 3]        # resumed after step 1
    for step, loss in port_losses.items():
        assert abs(loss - ref_losses[step]) <= 1e-4, step
    final = "step_00000003"
    names = sorted(f for f in os.listdir(os.path.join(ref_dir, final))
                   if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(os.path.join(
        port_dir, final)) if f.endswith(".npy"))
    for name in names:
        r = np.load(os.path.join(ref_dir, final, name))
        g = np.load(os.path.join(port_dir, final, name))
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert np.abs(g.astype(np.float64) - r).max() <= \
            1e-5 * np.abs(r).max(), name


@pytest.fixture
def smoke_registry(monkeypatch):
    """The port's registry resolves every arch to its smoke config."""
    monkeypatch.setattr(treg, "get_config",
                        lambda name, **kw: treg.smoke_config(name))


def _run(tmp_path, name, extra):
    out = str(tmp_path / f"{name}.jsonl")
    assert ttrain.main(SMOKE + ["--device", "cpu", "--steps", "6",
                                "--compress", "int8", "--metrics-out", out]
                       + extra) == 0
    with open(out) as f:
        return [json.loads(line) for line in f]


def test_fail_at_resumes_from_checkpoint_with_the_same_losses(
        tmp_path, capsys, smoke_registry):
    plain = _run(tmp_path, "plain", [])
    failed = _run(tmp_path, "failed", ["--ckpt-dir", str(tmp_path / "ck"),
                                       "--ckpt-every", "2", "--fail-at", "3"])
    assert "injected failure at step 3" in capsys.readouterr().out
    # steps 0-2 ran, the checkpoint of step 2 was restored, 3-5 ran again
    assert [r["step"] for r in failed] == [0, 1, 2, 3, 4, 5]
    assert "ckpt_bytes" in failed[2] and "ckpt_bytes" in failed[4]
    assert [r["loss"] for r in failed] == [r["loss"] for r in plain]
    assert [r["grad_norm"] for r in failed] == \
        [r["grad_norm"] for r in plain]


def test_mesh_and_prove_are_refused_as_the_reference_does(capsys,
                                                          smoke_registry):
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        ttrain.main(SMOKE + ["--device", "cpu", "--mesh", "2x1"])
    assert ttrain.parse_mesh("1x1") == (1, 1)
    assert ttrain.parse_mesh("2x16x16") == (2, 16, 16)
    with pytest.raises(SystemExit, match="bad --mesh"):
        ttrain.parse_mesh("4")
    with pytest.raises(SystemExit) as exc:
        ttrain.main(SMOKE + ["--device", "cpu", "--prove"])
    from repro.launch import train as rtrain
    with pytest.raises(SystemExit) as rexc:
        rtrain.main(["--arch", "qwen3-0.6b", "--prove"])
    # the same message, naming each package's own registry
    assert str(exc.value).replace("repro_torch.", "repro.") == \
        str(rexc.value)
    assert str(exc.value).startswith("--prove: ")


def test_steps_prefill_decode_and_specs():
    cfg = treg.smoke_config("qwen3_0p6b")
    opt_cfg = tsteps.default_opt_cfg(cfg)
    from repro.launch import steps as rsteps
    for arch in rreg.ARCHS:
        assert dataclasses.asdict(tsteps.default_opt_cfg(
            treg.get_config(arch))) == dataclasses.asdict(
                rsteps.default_opt_cfg(rreg.get_config(arch)))
    state, specs = ttrain.build_state(cfg, opt_cfg, device="cpu")
    for a, b in zip(tree_leaves(state), tree_leaves(specs)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert b.device.type == "meta"
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 9)), dtype=torch.int32)
    last, (k, v) = tsteps.build_prefill_step(cfg)(state["params"],
                                                  {"tokens": tokens[:, :8]})
    full, _ = tt.forward(cfg, state["params"], {"tokens": tokens[:, :8]})
    torch.testing.assert_close(last, full[:, -1].detach())
    assert k.shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim)
    cache = tt.make_cache(cfg, 2, 9, "cpu")
    cache["k"][:, :, :8], cache["v"][:, :, :8] = k, v
    logits, _ = tsteps.build_decode_step(cfg)(state["params"], cache,
                                              tokens[:, 8], 8)
    full, _ = tt.forward(cfg, state["params"], {"tokens": tokens})
    torch.testing.assert_close(logits.float(), full[:, -1].detach().float(),
                               rtol=2e-2, atol=2e-2)
