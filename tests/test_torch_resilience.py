"""The port's service-layer plumbing against the reference's:
`train/checkpoint`, `train/resilience`, and the framework-free
`launch/supervise` and `launch/admission`, which the port keeps as its
own copies.

The copies must stay the reference's code: their syntax trees, with the
docstrings taken out, are equal.  Checkpoints keep the reference's
on-disk layout and leaf names, and each package restores the other's.
The failure injector follows the reference's hit grammar and actions,
and its ``corrupt-cache`` action truncates a library of the port's
kernel build cache."""
import ast
import errno
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import admission as ref_admission
from repro.launch import supervise as ref_supervise
from repro.train import checkpoint as ref_checkpoint
from repro.train import resilience as ref_resilience

from repro_torch.launch import admission, supervise
from repro_torch.train import checkpoint
from repro_torch.train.checkpoint import StorageError, atomic_write_bytes
from repro_torch.train.resilience import (CheckpointPolicy, FailureInjector,
                                          SimulatedFailure, StragglerMonitor,
                                          corrupt_exec_cache_entry,
                                          run_resilient)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _code_only(module) -> str:
    """The module's syntax tree without its docstrings."""
    tree = ast.parse(open(module.__file__).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("port,ref", [(supervise, ref_supervise),
                                      (admission, ref_admission)],
                         ids=["supervise", "admission"])
def test_framework_free_copies_are_the_reference_code(port, ref):
    assert _code_only(port) == _code_only(ref)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _tree(lib):
    """One state tree, as numpy arrays (reference) or tensors (port)."""
    a = lambda x: x if lib is np else torch.as_tensor(x)       # noqa: E731
    return {"params": {"w": [a(np.arange(6, dtype=np.int64).reshape(2, 3)),
                             a(np.linspace(0, 1, 4, dtype=np.float32))],
                       "b": a(np.arange(3, dtype=np.int64))},
            "opt": ({"m": a(np.ones(2))}, a(np.array(7, dtype=np.int32))),
            "step": 5}


def test_checkpoint_layout_equals_reference(tmp_path):
    """The same tree writes the same file names, shapes and dtypes; each
    package restores the other's checkpoint."""
    ref_dir = ref_checkpoint.save(str(tmp_path / "ref"), 3, _tree(np))
    port_dir = checkpoint.save(str(tmp_path / "port"), 3, _tree(torch))
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    with open(os.path.join(ref_dir, "manifest.json")) as f:
        ref_man = json.load(f)
    with open(os.path.join(port_dir, "manifest.json")) as f:
        port_man = json.load(f)
    assert port_man == ref_man
    assert list(port_man["leaves"]) == list(ref_man["leaves"])
    for name in ref_man["leaves"]:
        r = np.load(os.path.join(ref_dir, name + ".npy"))
        p = np.load(os.path.join(port_dir, name + ".npy"))
        assert r.dtype == p.dtype and np.array_equal(r, p)

    template = _tree(torch)
    template["step"] = torch.tensor(0)
    got = checkpoint.restore(str(tmp_path / "ref"), 3, template,
                             device="cpu")
    assert torch.equal(got["params"]["w"][0], template["params"]["w"][0])
    assert isinstance(got["opt"], tuple) and int(got["opt"][1]) == 7
    assert int(got["step"]) == 5
    ref_template = _tree(np)
    ref_template["step"] = np.array(0)
    back = ref_checkpoint.restore(str(tmp_path / "port"), 3, ref_template)
    assert np.array_equal(np.asarray(back["params"]["w"][1]),
                          _tree(np)["params"]["w"][1])
    assert checkpoint.latest_step(str(tmp_path / "port")) == 3
    assert checkpoint.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_keeps_the_last_three(tmp_path):
    for step in range(5):
        checkpoint.save(str(tmp_path), step, {"w": torch.full((2,), step)})
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:08d}"
                                            for s in (2, 3, 4)]


def test_run_resilient_restarts_from_latest_checkpoint(tmp_path):
    """A SimulatedFailure mid-loop restarts from the last checkpoint,
    with the state restored as tensors, and the loop finishes."""
    policy = CheckpointPolicy(str(tmp_path), every=2)
    injector = FailureInjector(fail_at_step=5)
    starts = []

    def loop(state, start):
        starts.append(start)
        state = state if state is not None else {"w": torch.zeros(3)}
        for step in range(start, 8):
            injector.check(step)
            state = {"w": state["w"] + 1}
            policy.maybe_save(step, state)
        return state

    out = run_resilient(loop, {"w": torch.zeros(3)}, policy, device="cpu")
    assert starts == [0, 5]                # checkpoint at 4, resume at 5
    assert torch.equal(out["w"], torch.full((3,), 8.0))


def test_straggler_monitor_matches_reference():
    times = [1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 4.0]
    port, ref = StragglerMonitor(), ref_resilience.StragglerMonitor()
    assert ([port.observe(i, t) for i, t in enumerate(times)]
            == [ref.observe(i, t) for i, t in enumerate(times)])
    assert port.events == ref.events and port.events


def test_atomic_write_storage_error_is_typed_with_no_tmp_orphan(
        tmp_path, monkeypatch):
    target = tmp_path / "proof.bin"

    def full_disk(src, dst):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(checkpoint.os, "replace", full_disk)
    with pytest.raises(StorageError) as ei:
        atomic_write_bytes(str(target), b"x" * 64)
    assert ei.value.is_enospc and isinstance(ei.value, OSError)
    assert not target.exists()
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


# ---------------------------------------------------------------------------
# failure injection
# ---------------------------------------------------------------------------

def _events(cls, spec, points, once_dir=None):
    inj = cls.from_spec(spec, once_dir=once_dir)
    out = []
    for p in points:
        try:
            inj.fire(p)
            out.append("-")
        except ref_resilience.SimulatedFailure:
            out.append("raise")
        except SimulatedFailure:
            out.append("raise")
        except OSError as exc:
            out.append(f"errno {exc.errno}")
    return out, inj.events


@pytest.mark.parametrize("spec", [
    "prove/mid@1", "prove/mid@1-2", "prove/mid@*", "prove/mid",
    "storage/journal@0:enospc,prove/mid@2:raise"])
def test_injector_hit_grammar_matches_reference(spec):
    points = ["prove/mid", "storage/journal", "prove/mid", "prove/mid",
              "storage/journal"]
    assert (_events(FailureInjector, spec, points)
            == _events(ref_resilience.FailureInjector, spec, points))


def test_injector_once_dir_fires_once_across_injectors(tmp_path):
    """Two injectors sharing ``once_dir`` (two processes' view): each
    selected hit acts once in all; ``from_env`` reads the same spec."""
    once = str(tmp_path / "fired")
    assert _events(FailureInjector, "prove/mid@0", ["prove/mid"],
                   once)[0] == ["raise"]
    assert _events(FailureInjector, "prove/mid@0", ["prove/mid"],
                   once)[0] == ["-"]
    assert os.listdir(once) == ["fired_prove_mid_0"]
    env = {"ZKDL_FAULTS": "commit/pre-manifest@0",
           "ZKDL_FAULTS_ONCE": str(tmp_path / "env")}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        inj = FailureInjector.from_env()
    finally:
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.update({k: v})
    assert inj.faults == {"commit/pre-manifest": "0"}
    assert inj.once_dir == env["ZKDL_FAULTS_ONCE"]
    assert FailureInjector.from_env("ZKDL_NO_SUCH_VAR") is None


def test_injector_kill_action_is_a_real_sigkill():
    code = ("from repro_torch.train.resilience import FailureInjector; "
            "FailureInjector.from_spec('worker/kill@0:kill')"
            ".fire('worker/kill'); print('survived')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == -signal.SIGKILL
    assert "survived" not in res.stdout


def test_corrupt_cache_truncates_a_built_library(tmp_path, monkeypatch):
    """The ``corrupt-cache`` action halves the oldest library in the
    kernel build cache by rename (a process that maps it keeps its
    pages), and is a no-op on an empty or missing cache."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    assert corrupt_exec_cache_entry() is None
    (tmp_path / "kernels").mkdir()
    assert corrupt_exec_cache_entry() is None
    for name in ("qmatmul-1.so", "modmul-2.so"):
        (tmp_path / "kernels" / name).write_bytes(b"\x7fELF" + b"x" * 996)
    inode = os.stat(tmp_path / "kernels" / "modmul-2.so").st_ino
    events = _events(FailureInjector, "prove/mid@0:corrupt-cache",
                     ["prove/mid"])
    assert events == (["-"], ["prove/mid#0:corrupt-cache"])
    path = tmp_path / "kernels" / "modmul-2.so"
    assert path.read_bytes() == b"\x7fELF" + b"x" * 496
    assert os.stat(path).st_ino != inode
    assert (tmp_path / "kernels" / "qmatmul-1.so").stat().st_size == 1000


# ---------------------------------------------------------------------------
# supervise and admission (the copies, exercised)
# ---------------------------------------------------------------------------

def test_supervised_retry_and_subprocess_policy():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    res = supervise.run_supervised(flaky, max_attempts=3,
                                   sleep=lambda s: None)
    assert res.ok and res.value == "ok" and res.n_attempts == 3
    assert res.last_error == "RuntimeError: transient"
    killed = supervise.run_subprocess_supervised(
        [sys.executable, "-c", "import os, signal; "
                               "os.kill(os.getpid(), signal.SIGKILL)"],
        max_attempts=2, sleep=lambda s: None)
    assert not killed.ok and [a.signal for a in killed.attempts] == [9, 9]
    clean = supervise.run_subprocess_supervised(
        [sys.executable, "-c", "raise SystemExit(3)"], max_attempts=3,
        sleep=lambda s: None)
    assert clean.n_attempts == 1 and clean.last_error == "exit 3"


def test_weighted_fair_queue_and_breaker_match_reference():
    def drive(mod):
        q = mod.WeightedFairQueue(capacity=5)
        q.add_tenant("a", weight=2.0, priority=1)
        q.add_tenant("b", weight=1.0)
        shed = []
        for i in range(4):
            shed += q.push("a", f"a{i}")
            shed += q.push("b", f"b{i}")
        order = [q.pop(timeout=0) for _ in range(q.depth())]
        now = [0.0]
        br = mod.CircuitBreaker(threshold=2, reset_s=1.0,
                                clock=lambda: now[0])
        states = []
        for step in ("fail", "fail", "allow", "tick", "allow", "allow",
                     "ok", "allow"):
            if step == "fail":
                states.append(br.record_failure())
            elif step == "ok":
                br.record_success()
            elif step == "tick":
                now[0] += 1.5
            else:
                states.append(br.allow())
            states.append(br.state)
        return shed, order, states
    assert drive(admission) == drive(ref_admission)


def test_dir_lock_round_trip_and_busy(tmp_path):
    path = admission.acquire_dir_lock(str(tmp_path))
    with pytest.raises(admission.GatewayBusyError):
        admission.acquire_dir_lock(str(tmp_path))
    admission.release_dir_lock(path)
    assert not os.path.exists(path)
    admission.release_dir_lock(admission.acquire_dir_lock(str(tmp_path)))


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    """No import statement of `repro_torch` or chip_smoke.py names jax or
    the reference package, and every module of the port (the service
    layer included) imports with both unavailable."""
    root = os.path.dirname(SRC)
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, m)
    modules = sorted(
        os.path.relpath(p, SRC)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__") for p in files[1:])
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('isolated', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "isolated" in res.stdout
