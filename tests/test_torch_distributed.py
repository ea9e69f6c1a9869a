"""The port's DeviceMesh / DTensor training path on the CPU, over gloo.

Each multi-rank run is ``torchrun --standalone`` in its own subprocess,
on the qwen3 smoke geometry in float32 (``--layers 2 --d-model 64
--seq 32 --global-batch 4 --compress int8``, the registry bound to the
smoke config as `test_torch_lm_train.py` binds it):

* ``--mesh 1x1`` (a gloo world of one) gives the plain path's losses
  and grad norms bit for bit; the plain path is held to the reference
  trainer by `test_torch_lm_train.py`.
* ``--mesh 2x2`` (4 ranks), with a failure injected at step 5 and
  checkpoints every 3 steps, gives the 1x1 run's losses and grad norms
  within 1e-5 relative, the restarted steps included.
* Elastic restart: that checkpoint directory resumes on ``--mesh 2x1``
  (2 ranks) at step 7 and finishes at step 11, again within 1e-5.  The
  reference's test goes from 4x2 to 2x2 (`tests/test_elastic_restart.py`);
  here both meshes are halved to fit the test budget.
* The MoE per-shard dispatch (`local_map` over the batch axes, the
  expert combine's partial sums reduced over 'model') on 2x2 matches
  the one-device path to 2e-5, outputs and parameter gradients, on the
  config and tolerance of `tests/test_moe_parity.py`; in the same run,
  ``seq_shard_carry`` with ``fsdp`` gives one device's loss and
  gradients to 1e-5.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")

TRAIN = r"""
import dataclasses, sys
from repro_torch.configs import registry
registry.get_config = lambda name, **kw: dataclasses.replace(
    registry.smoke_config(name), dtype="float32")
from repro_torch.launch import train
sys.exit(train.main(sys.argv[1:]))
"""

MOE = r"""
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed import sharding
from repro_torch.launch import steps, train
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_unflatten
from torch.distributed.tensor import Shard
from torch.distributed.tensor.experimental import implicit_replication

cfg = ModelConfig(name="moe-parity", family="moe", n_layers=1, d_model=32,
                  n_heads=4, n_kv_heads=4, d_ff=0, vocab=64,
                  n_experts=4, top_k=2, moe_d_ff=16, n_shared_experts=1,
                  capacity_factor=2.0, remat=False)
params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
x = torch.as_tensor(np.random.default_rng(1).normal(
    size=(8, 16, 32)).astype(np.float32))


def run(p, x):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
    out = moe.moe_ffn(tree_unflatten(p, leaves), x, cfg)
    sq = (out * out).sum()
    sq = sq.full_tensor() if hasattr(sq, "full_tensor") else sq
    return out, torch.autograd.grad(sq, leaves)


ref, ref_g = run(params, x)                  # one device, plain tensors
mesh, _, _ = train.start_mesh("2x2", "cpu")
steps.set_mesh_hints(mesh)
shard = sharding.param_shardings(cfg, mesh, {"moe": params})["moe"]
xd = steps.place({"x": x}, sharding.batch_shardings(cfg, mesh, {"x": x}))
with implicit_replication():
    out, g = run(steps.place(params, shard), xd["x"])
assert out.placements[0] == Shard(0), out.placements     # batch-sharded
np.testing.assert_allclose(out.full_tensor().detach().numpy(),
                           ref.detach().numpy(), rtol=2e-5, atol=2e-5)
for a, b in zip(g, ref_g):
    np.testing.assert_allclose(a.full_tensor().numpy(), b.numpy(),
                               rtol=2e-5, atol=2e-5)
if dist.get_rank() == 0:
    print("MOE_PARITY_OK", flush=True)

# the Megatron-SP carry (the residual stream S-sharded over 'model'
# between blocks) and FSDP (weights sharded over 'data', gathered per
# layer), on the qwen3 smoke config
import dataclasses
from repro_torch.configs import registry
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models import transformer

cfg = dataclasses.replace(registry.smoke_config("qwen3_0p6b"),
                          dtype="float32", seq_shard_carry=True, fsdp=True)
params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
batch = {k: torch.as_tensor(v)
         for k, v in SyntheticTokens(cfg, 32, 4).batch(0).items()}
loss, grads = steps.value_and_grad(cfg, params, batch)
with implicit_replication():
    dloss, dgrads = steps.value_and_grad(
        cfg, steps.place(params, sharding.param_shardings(cfg, mesh, params)),
        steps.place(batch, sharding.batch_shardings(cfg, mesh, batch)))
assert abs(float(dloss.full_tensor()) - float(loss)) <= 1e-5 * float(loss)
for a, b in zip(tree_leaves(dgrads), tree_leaves(grads)):
    np.testing.assert_allclose(a.full_tensor().numpy(), b.numpy(),
                               rtol=1e-5, atol=1e-5 * float(b.abs().max()))
if dist.get_rank() == 0:
    print("SEQ_SHARD_CARRY_OK", flush=True)
dist.destroy_process_group()
"""

BASE = ["--arch", "qwen3-0.6b", "--layers", "2", "--d-model", "64",
        "--seq", "32", "--global-batch", "4", "--compress", "int8",
        "--device", "cpu", "--log-every", "1"]


def _torchrun(tmp, nproc: int, code: str, args, timeout=300):
    script = os.path.join(tmp, f"script_{abs(hash(code))}.py")
    with open(script, "w") as f:
        f.write(code)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}", script, *args],
        capture_output=True, text=True, timeout=timeout, env=env)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    return res.stdout


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import train

    tmp = str(tmp_path_factory.mktemp("mesh_runs"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "get_config", lambda name, **kw:
                   dataclasses.replace(registry.smoke_config(name),
                                       dtype="float32"))
        for name, extra in (("plain", []), ("1x1", ["--mesh", "1x1"])):
            path = os.path.join(tmp, name + ".jsonl")
            assert train.main(BASE + ["--steps", "12", "--metrics-out",
                                      path] + extra) == 0
            out[name] = _records(path)
    ckpt = os.path.join(tmp, "ckpt")
    for name, nproc, mesh, extra in (
            ("2x2", 4, "2x2", ["--steps", "8", "--fail-at", "5"]),
            ("2x1", 2, "2x1", ["--steps", "12"])):
        path = os.path.join(tmp, name + ".jsonl")
        out[name + "_stdout"] = _torchrun(
            tmp, nproc, TRAIN, BASE + extra + [
                "--mesh", mesh, "--ckpt-dir", ckpt, "--ckpt-every", "3",
                "--metrics-out", path])
        out[name] = _records(path)
    return out


def _close(recs, want, rel=1e-5):
    by_step = {r["step"]: r for r in want}
    for r in recs:
        w = by_step[r["step"]]
        for key in ("loss", "grad_norm"):
            assert abs(r[key] - w[key]) <= rel * abs(w[key]), (r, w)


def test_mesh_1x1_is_the_plain_path_bit_for_bit(runs):
    assert [(r["loss"], r["grad_norm"]) for r in runs["1x1"]] == \
        [(r["loss"], r["grad_norm"]) for r in runs["plain"]]
    assert runs["1x1"][0]["state_bytes"] == runs["plain"][0]["state_bytes"]


def test_2x2_trains_like_1x1_through_a_restart(runs):
    recs = runs["2x2"]
    # steps 0-5 ran, 5 failed, the checkpoint of step 3 was restored
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert "injected failure at step 5" in runs["2x2_stdout"]
    assert "mesh 2x2 ('data', 'model')" in runs["2x2_stdout"]
    _close(recs, runs["1x1"])
    # each rank holds a quarter of the sharded state or less
    assert recs[0]["state_bytes"] < runs["1x1"][0]["state_bytes"]


def test_checkpoint_from_2x2_resumes_on_2x1(runs):
    recs = runs["2x1"]
    assert [r["step"] for r in recs] == list(range(7, 12))
    assert "done: 12 steps" in runs["2x1_stdout"]
    _close(recs, runs["1x1"])


@pytest.fixture(scope="module")
def moe_and_sp(tmp_path_factory):
    return _torchrun(str(tmp_path_factory.mktemp("moe")), 4, MOE, [])


def test_moe_local_map_dispatch_matches_one_device(moe_and_sp):
    assert "MOE_PARITY_OK" in moe_and_sp


def test_seq_shard_carry_and_fsdp_match_one_device(moe_and_sp):
    """``seq_shard_carry`` (no registered arch sets it) with ``fsdp`` on
    2x2: the smoke qwen3's loss and gradients within 1e-5 of one
    device."""
    assert "SEQ_SHARD_CARRY_OK" in moe_and_sp
