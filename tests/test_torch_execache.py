"""The port's kernel build cache (`repro_torch.core.execache`) on the CPU.

The counters carry the reference's names (`repro.core.execache.stats`).
A library's file name is a hash of its sources and nvcc flags: the same
in every process, and changed by any edit of a source, the shared
header or the flags.  A library file whose digest does not match the
one written beside it, or that fails to load, is counted, deleted and
rebuilt, never used.  Building and loading a kernel needs
the card (tests/test_torch_gpu.py); nothing here calls nvcc.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro.core import execache as ref_execache
from repro_torch.core import execache
from repro_torch.kernels import _build

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def test_stats_schema_is_the_references(monkeypatch):
    monkeypatch.setattr(_build, "_libs", {"modmul": object()})
    execache.clear()                     # drops loaded libraries only
    assert _build._libs == {}
    s = execache.stats()
    assert set(s) == set(ref_execache.stats())
    assert all(isinstance(v, int) for v in s.values())
    s["misses"] += 99                      # a copy, not the live counters
    assert execache.stats()["misses"] != s["misses"]
    execache.reset_stats()
    assert set(execache.stats().values()) == {0}
    assert execache.cache_dir() == str(_build.BUILD_DIR)


def test_lib_path_stable_across_processes():
    code = ("import json; from repro_torch.kernels import _build; "
            "print(json.dumps({n: str(_build._lib_path(n)) "
            "for n in _build.SOURCES}))")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out) == {n: str(_build._lib_path(n))
                               for n in _build.SOURCES}


def test_lib_path_changes_with_sources_and_flags(tmp_path, monkeypatch):
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert len(set(before.values())) == len(before)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert all(_build._lib_path(n) != before[n] for n in _build.SOURCES)
    monkeypatch.undo()

    kdir = tmp_path / "kernels"
    shutil.copytree(_build.KERNEL_DIR, kdir)
    monkeypatch.setattr(_build, "KERNEL_DIR", kdir)
    assert {n: _build._lib_path(n) for n in _build.SOURCES} == before
    with open(kdir / _build.SOURCES["sumcheck_fold"], "a") as f:
        f.write("\n// edited\n")
    moved = {n for n in _build.SOURCES if _build._lib_path(n) != before[n]}
    assert moved == {"sumcheck_fold"}
    with open(kdir / _build.HEADERS[0], "a") as f:
        f.write("\n// edited\n")
    assert all(_build._lib_path(n) != before[n] for n in _build.SOURCES)


def test_corrupt_library_is_counted_deleted_and_rebuilt(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "stats", dict.fromkeys(_build.stats, 0))
    paths = [_build._lib_path(n) for n in _build.SOURCES]
    for p in paths:
        p.write_bytes(b"not a shared library")
    compiled = []

    def no_nvcc():
        compiled.append(True)
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.lib("modmul")
    s = execache.stats()
    assert s["disk_corrupt"] == len(paths)
    assert s["disk_hits"] == 0 and s["misses"] == 0
    assert not any(p.exists() for p in paths)
    assert compiled                      # the rebuild was attempted


def test_truncated_library_never_reaches_the_loader(tmp_path, monkeypatch):
    """A library is loaded only when its SHA-256 matches the digest the
    cache wrote beside it: a truncated one (the ``corrupt-cache`` fault)
    is counted and deleted unloaded, since mapping it can kill the
    process with SIGBUS instead of raising."""
    import hashlib

    from repro_torch.train.resilience import corrupt_exec_cache_entry

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "stats", dict.fromkeys(_build.stats, 0))
    for n in _build.SOURCES:
        p = _build._lib_path(n)
        p.write_bytes(b"\x7fELF" + bytes(range(256)) * 4)
        _build._digest_path(p).write_text(
            hashlib.sha256(p.read_bytes()).hexdigest() + "\n")
        assert _build._intact(p)
    loaded = []
    monkeypatch.setattr(_build, "_load",
                        lambda p: loaded.append(p.name) or object())
    bad = corrupt_exec_cache_entry()
    assert not _build._intact(tmp_path / os.path.basename(bad))
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    s = execache.stats()
    assert s["disk_corrupt"] == 1 and s["disk_hits"] == len(_build.SOURCES) - 1
    assert os.path.basename(bad) not in loaded
    assert not os.path.exists(bad)


def test_warm_returns_stats_delta_on_cpu():
    from repro_torch.core.pipeline import build_fcnn_graph, compile
    from repro_torch.core.quantfc import QuantConfig

    pk, _ = compile(build_fcnn_graph((4, 4, 4), batch=2), QuantConfig(16, 4),
                    n_steps=1, device="cpu")
    delta = pk.warm()
    assert set(delta) == set(ref_execache.stats())
    assert set(delta.values()) == {0}        # the CPU builds no kernel
    assert pk.exec_stats() == execache.stats()
