"""The port's dry run (`repro_torch.launch.dryrun`) on the 16x16
production mesh, in a subprocess that starts a fake process group of
256 ranks (as the dry run's entry point does; no test process keeps a
process group).

* ``run_cell("qwen3-0.6b", "train_4k")`` is ``ok`` and carries the
  reference's record keys; its argument bytes equal the bytes of each
  device's shard of the train state and the batch, computed here from
  the reference's own specs and sharding rules.
* ``long_500k`` on a dense arch is skipped with the reference's reason.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np

from repro.configs import registry as rreg
from repro.distributed import sharding as rsh
from repro.launch import specs as rspecs
from repro.launch import steps as rsteps

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
SCRIPT = r"""
import json
from repro_torch.launch import dryrun
dryrun.init_fake_world(256)
recs = [dryrun.run_cell("qwen3-0.6b", "train_4k"),
        dryrun.run_cell("qwen3-0.6b", "long_500k")]
print("RECORDS " + json.dumps(recs))
"""


class RefMesh:                     # what the reference's rules read
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


def _local_bytes(leaf, spec) -> int:
    shape = list(leaf.shape)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                shape[d] //= RefMesh.shape[name]
    return math.prod(shape) * np.dtype(leaf.dtype).itemsize


def _expected_argument_bytes(monkeypatch) -> int:
    monkeypatch.setattr(rsh, "NamedSharding", lambda mesh, spec: spec)
    cfg = rreg.get_config("qwen3-0.6b")
    state = rsteps.state_specs(cfg, rsteps.default_opt_cfg(cfg))
    total = 0
    for tree in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, leaf in flat:
            spec = rsh.param_spec(cfg, RefMesh, path, leaf.shape)
            total += _local_bytes(leaf, spec)
    total += _local_bytes(state["opt"]["step"], ())
    batch = rspecs.train_batch_specs(cfg, 4096, 256)
    specs = rsh.batch_shardings(cfg, RefMesh, batch)
    for key, leaf in batch.items():
        total += _local_bytes(leaf, specs[key])
    return total


def test_dryrun_cell_on_the_production_mesh(monkeypatch):
    res = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("RECORDS ")][-1]
    train, long = json.loads(line[len("RECORDS "):])

    assert train["status"] == "ok", train
    assert train["mesh"] == "16x16" and train["n_chips"] == 256
    for key in ("per_device_flops", "per_device_bytes",
                "per_device_collective_bytes", "collective_breakdown",
                "per_device_live_bytes", "compute_term_s", "memory_term_s",
                "collective_term_s"):
        assert train[key] > 0 if not isinstance(train[key], dict) \
            else sum(train[key].values()) > 0, key
    assert {c["key"] for c in train["covers"]} >= {
        "per_device_collective_bytes_unscaled",
        "memory.generated_code_size_in_bytes"}
    args = train["memory"]["argument_size_in_bytes"]
    assert args == _expected_argument_bytes(monkeypatch)
    assert train["per_device_live_bytes"] > args
    assert train["memory"]["output_size_in_bytes"] >= args - 2 * 256 * 4096

    cfg = rreg.get_config("qwen3-0.6b")
    assert long == {"arch": "qwen3-0.6b", "shape": "long_500k",
                    "mesh": "16x16", "status": "skipped",
                    "reason": rspecs.applicable(cfg, "long_500k")[1]}
