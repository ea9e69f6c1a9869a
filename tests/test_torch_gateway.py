"""Multi-tenant chaos harness for the port's proving gateway
(`repro_torch.launch.serve.ProvingGateway`) on the CPU: the contracts of
tests/test_gateway_chaos.py with the port's prover behind the pool.

Every window that was not load-shed or storage-dropped ends with EXACTLY
ONE ``COMMITTED`` line in its tenant's directory, its proof verifies
from disk, and its journal segments are GC'd, across worker deaths,
ENOSPC at every write site, expired deadlines, tripped breakers and
restarts.  Windows are T = 1 (T = 2 where a partial window is needed),
each scenario with the fewest windows its contract needs.  Also here:
the per-label generator cache under many threads, which the pool's
workers share."""
import dataclasses
import functools
import inspect
import os
import sys
import threading
import time

import pytest
import torch

from repro_torch.core import group
from repro_torch.core.pipeline import build_fcnn_graph, verify_bytes
from repro_torch.core.pipeline.proofio import decode_vk
from repro_torch.core.quantfc import (QuantConfig,
                                      synthetic_sgd_trajectory_widths)
from repro_torch.launch import serve
from repro_torch.launch.admission import GatewayBusyError, ServiceClosedError
from repro_torch.launch.preflight import WitnessQuantError, WitnessStepError
from repro_torch.launch.serve import ProverService, ProvingGateway
from repro_torch.train.checkpoint import StorageError
from repro_torch.train.resilience import FailureInjector

QC = QuantConfig(q_bits=16, r_bits=4)
WIDTHS = (4, 4, 4)
B = 2
LABEL = b"zkdl/train"
GRAPH = build_fcnn_graph(WIDTHS, batch=B)


def _gateway(out_dir, **kw):
    kw.setdefault("backoff_base", 0.01)
    kw.setdefault("backoff_cap", 0.05)
    return ProvingGateway(str(out_dir), device="cpu", **kw).start()


def _add(gw, name, seed, T=1, **kw):
    return gw.add_tenant(name, GRAPH, QC, n_steps=T, rng_seed=seed, **kw)


@functools.lru_cache(maxsize=None)
def _wits(n, seed):
    return tuple(synthetic_sgd_trajectory_widths(n, WIDTHS, B, QC, seed=seed,
                                                 device="cpu"))


def _wait(pred, timeout=600):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(
                f"not reached within {timeout} s: "
                f"{inspect.getsource(pred).strip()}")
        time.sleep(0.02)


@functools.lru_cache(maxsize=None)
def _verified(vk_bytes: bytes, raw: bytes) -> bool:
    return verify_bytes(decode_vk(vk_bytes, device="cpu"), raw, label=LABEL)


def _assert_exactly_once(tdir, windows, T=1):
    man = serve.read_manifest(tdir)
    counts = serve.manifest_commit_counts(tdir)
    with open(os.path.join(tdir, "vk.bin"), "rb") as f:
        vk_bytes = f.read()
    for w in windows:
        assert man.get(w, {}).get("status") == serve.COMMITTED, \
            f"{tdir} window {w}: {man.get(w)}"
        assert counts[w] == 1, f"window {w} committed {counts[w]} times"
        with open(os.path.join(tdir, f"proof_{w:06d}.bin"), "rb") as f:
            assert _verified(vk_bytes, f.read()), f"window {w} rejected"
    for w in windows:
        assert not any(s // T == w for s in
                       serve.journal_steps(serve.journal_dir(tdir)))


def test_two_tenants_worker_deaths_reclaimed_and_status_agrees(tmp_path):
    """Two tenants on a pool of 2; the first two dequeues kill their
    worker thread.  The monitor requeues each in-flight window and
    respawns the slot, every window commits once, the lock is released,
    and the from-disk `dir_status` agrees with the live `status()`."""
    gw = _gateway(tmp_path, n_workers=2,
                  injector=FailureInjector.from_spec("pool/worker-kill@0-1"))
    ta = _add(gw, "alice", 11, weight=2.0)
    tb = _add(gw, "bob", 22)
    gw.submit("alice", _wits(1, 11)[0])
    gw.submit("bob", _wits(1, 22)[0])
    _wait(lambda: ta.stats["proved"] == 1 and tb.stats["proved"] == 1)
    gw.close(timeout=600)
    assert gw.stats["worker_respawns"] == 2
    assert len(gw.status()["workers"]["events"]) == 2
    _assert_exactly_once(ta.dir, [0])
    _assert_exactly_once(tb.dir, [0])
    assert not os.path.exists(os.path.join(str(tmp_path), "GATEWAY.lock"))
    live, disk = gw.status(), serve.dir_status(str(tmp_path))
    assert live["closed"] and live["queue"]["depth"] == 0
    assert disk["lock"] is None
    for name in ("alice", "bob"):
        d = disk["tenants"][name]
        assert (d["by_status"] == {"COMMITTED": 1} and d["commit_lines"]
                == d["proof_files"] == live["tenants"][name]["committed"])
        assert d["journal_steps"] == 0


def test_job_that_kills_every_worker_fails_terminally(tmp_path):
    gw = _gateway(tmp_path, n_workers=1, max_attempts=2,
                  injector=FailureInjector.from_spec("pool/worker-kill@0-1"))
    ta = _add(gw, "alice", 11)
    for wit in _wits(2, 11):
        gw.submit("alice", wit)
    _wait(lambda: ta.stats["proved"] == 1
          and ta.stats["failed_windows"] == 1)
    gw.close(timeout=600)
    man = serve.read_manifest(ta.dir)
    assert man[0]["status"] == serve.FAILED
    assert man[0]["reason"] == "worker-death"
    _assert_exactly_once(ta.dir, [1])
    assert serve.journal_steps(serve.journal_dir(ta.dir)) == [0]


def test_journal_enospc_drop_and_block_policies(tmp_path):
    """``drop_window`` turns a full disk at the journal write into a
    terminal DROPPED window with no orphan temp file; ``block`` retries
    it with backoff; a disk that stays full raises the typed error with
    nothing journaled, and the same step goes through once it frees."""
    gw = _gateway(tmp_path / "drop", n_workers=1,
                  backpressure="drop_window",
                  injector=FailureInjector.from_spec(
                      "storage/journal@0:enospc"))
    ta = _add(gw, "alice", 11)
    for wit in _wits(2, 11):
        gw.submit("alice", wit)     # never raises under drop_window
    gw.close(timeout=600)
    man = serve.read_manifest(ta.dir)
    assert man[0]["status"] == serve.DROPPED
    assert man[0]["reason"] == "storage"
    assert ta.stats["dropped_windows"] == 1
    assert ta.stats["storage_errors"] == 1
    _assert_exactly_once(ta.dir, [1])
    for root, _dirs, files in os.walk(ta.dir):
        assert not [f for f in files if ".tmp." in f], (root, files)

    gw = _gateway(tmp_path / "block", n_workers=1, max_attempts=2,
                  injector=FailureInjector.from_spec(
                      "storage/journal@0-1:enospc"))
    tb = _add(gw, "bob", 22)
    wit = _wits(1, 22)[0]
    with pytest.raises(StorageError) as ei:
        gw.submit("bob", wit)
    assert ei.value.is_enospc
    assert tb.stats["journaled"] == 0 and tb.next_step == 0
    assert serve.journal_steps(serve.journal_dir(tb.dir)) == []
    gw.injector = FailureInjector.from_spec("storage/journal@0:enospc")
    gw.submit("bob", wit)           # one transient ENOSPC, retried
    gw.close(timeout=600)
    assert tb.stats["storage_errors"] == 3 and tb.stats["journaled"] == 1
    _assert_exactly_once(tb.dir, [0])


def test_proof_write_enospc_fails_window_keeps_journal(tmp_path):
    """ENOSPC at the proof write: the window FAILS (reason storage) with
    its journal retained and the breaker closed; a restart with space
    re-proves it."""
    gw = _gateway(tmp_path, n_workers=1,
                  injector=FailureInjector.from_spec(
                      "storage/proof@0:enospc"))
    ta = _add(gw, "alice", 11)
    gw.submit("alice", _wits(1, 11)[0])
    gw.close(timeout=600)
    man = serve.read_manifest(ta.dir)
    assert man[0]["status"] == serve.FAILED
    assert man[0]["reason"] == "storage"
    assert ta.stats["storage_errors"] == 1
    assert ta.breaker.state == "closed"
    assert serve.journal_steps(serve.journal_dir(ta.dir)) == [0]
    gw2 = _gateway(tmp_path, n_workers=1)
    ta2 = _add(gw2, "alice", 11)
    gw2.close(timeout=600)
    _assert_exactly_once(ta2.dir, [0])


def test_manifest_enospc_never_gcs_ahead_of_commit_line(tmp_path):
    gw = _gateway(tmp_path, n_workers=1,
                  injector=FailureInjector.from_spec(
                      "storage/manifest@0:enospc"))
    ta = _add(gw, "alice", 11)
    gw.submit("alice", _wits(1, 11)[0])
    _wait(lambda: ta.stats["storage_errors"] >= 1)
    gw.close(timeout=600)
    assert ta.stats["proved"] == 0
    assert serve.manifest_commit_counts(ta.dir) == {}
    assert serve.journal_steps(serve.journal_dir(ta.dir)) == [0]
    gw2 = _gateway(tmp_path, n_workers=1)
    ta2 = _add(gw2, "alice", 11)
    assert ta2.stats["replayed"] == 1
    gw2.close(timeout=600)
    _assert_exactly_once(ta2.dir, [0])


def test_expired_deadline_fails_window_and_frees_worker(tmp_path):
    gw = _gateway(tmp_path, n_workers=1)
    ta = _add(gw, "alice", 11, deadline_s=0.0)
    for wit in _wits(2, 11):
        gw.submit("alice", wit)
    gw.close(timeout=600)
    man = serve.read_manifest(ta.dir)
    for w in (0, 1):
        assert man[w]["status"] == serve.FAILED
        assert man[w]["reason"] == "deadline" and "waited_s" in man[w]
    assert ta.stats["deadline_expired"] == 2 and ta.stats["proved"] == 0
    assert ta.breaker.state == "closed"
    assert serve.journal_steps(serve.journal_dir(ta.dir)) == [0, 1]


def test_breaker_trips_parks_then_half_open_recovers(tmp_path):
    """Two consecutive prove failures trip the breaker; later windows
    PARK (journal retained) until the half-open trial succeeds; a
    restart re-proves the FAILED windows from their journals."""
    gw = _gateway(tmp_path, n_workers=1, max_attempts=1,
                  breaker_threshold=2, breaker_reset_s=0.5,
                  injector=FailureInjector.from_spec(
                      "gateway/pre-prove@0-1"))
    ta = _add(gw, "alice", 11)
    for wit in _wits(4, 11):
        gw.submit("alice", wit)
    _wait(lambda: ta.stats["proved"] == 2)      # w2 (trial) + w3
    gw.close(timeout=600)
    man = serve.read_manifest(ta.dir)
    assert man[0]["status"] == serve.FAILED and man[0]["reason"] == "prove"
    assert man[1]["status"] == serve.FAILED and man[1]["reason"] == "prove"
    assert ta.breaker.trips == 1 and ta.stats["deferred"] >= 2
    _assert_exactly_once(ta.dir, [2, 3])
    assert serve.journal_steps(serve.journal_dir(ta.dir)) == [0, 1]
    gw2 = _gateway(tmp_path, n_workers=1)
    ta2 = _add(gw2, "alice", 11)
    assert ta2.stats["replayed"] == 2
    gw2.close(timeout=600)
    _assert_exactly_once(ta2.dir, [0, 1, 2, 3])


def test_shed_window_is_terminal_and_accounted(tmp_path):
    gw = _gateway(tmp_path, n_workers=1)
    ta = _add(gw, "alice", 11, T=2)
    gw._mark_shed(ta, serve.WindowJob(window=5, wits=[], enqueued_t=0.0))
    assert ta.stats["shed_windows"] == 1 and 5 in ta.dropped
    man = serve.read_manifest(ta.dir)
    assert man[5]["status"] == serve.SHED and man[5]["reason"] == "admission"
    assert ta.snapshot(0)["shed"] == 1
    gw.close(timeout=600)
    gw2 = _gateway(tmp_path, n_workers=1)
    assert _add(gw2, "alice", 11, T=2).next_step == 12
    gw2.close(timeout=600)


def test_lockfile_blocks_second_gateway_and_service(tmp_path):
    gw = _gateway(tmp_path, n_workers=1)
    with pytest.raises(GatewayBusyError):
        ProvingGateway(str(tmp_path), device="cpu").start()
    with pytest.raises(GatewayBusyError):
        ProverService(GRAPH, QC, n_steps=1, out_dir=str(tmp_path),
                      device="cpu").start(warm=False)
    gw.close(timeout=600)
    _gateway(tmp_path, n_workers=1).close(timeout=600)


def test_preflight_rejects_before_journal(tmp_path):
    gw = _gateway(tmp_path, n_workers=1)
    ta = _add(gw, "alice", 11)
    wit = _wits(1, 11)[0]
    bad = dataclasses.replace(wit, cfg=QuantConfig(q_bits=8, r_bits=2))
    with pytest.raises(WitnessQuantError):
        gw.submit("alice", bad)
    with pytest.raises(WitnessStepError):
        gw.submit("alice", wit, step=3)     # gap vs next_step=0
    assert ta.stats["rejected"] == 2 and ta.stats["journaled"] == 0
    assert serve.journal_steps(serve.journal_dir(ta.dir)) == []
    gw.submit("alice", wit)                 # valid work still flows
    gw.close(timeout=600)
    _assert_exactly_once(ta.dir, [0])


def test_gateway_restart_resumes_every_tenant(tmp_path):
    gw = _gateway(tmp_path, n_workers=1)
    _add(gw, "alice", 11, T=2)
    _add(gw, "bob", 22, T=2)
    wa, wb = _wits(4, 11), _wits(4, 22)
    for wit in wa[:3]:                  # window 0 + trailing partial
        gw.submit("alice", wit)
    for wit in wb[:2]:                  # window 0 only
        gw.submit("bob", wit)
    gw.close(timeout=600)
    man_a = serve.read_manifest(os.path.join(str(tmp_path), "tenants",
                                             "alice"))
    assert man_a[1]["status"] == serve.PARTIAL
    gw2 = _gateway(tmp_path, n_workers=1)
    ta = _add(gw2, "alice", 11, T=2)
    tb = _add(gw2, "bob", 22, T=2)
    assert ta.next_step == 3 and ta.stats["replayed"] == 1
    assert tb.next_step == 2 and tb.stats["replayed"] == 0
    gw2.submit("alice", wa[3])          # completes the partial window
    gw2.close(timeout=600)
    _assert_exactly_once(ta.dir, [0, 1], T=2)
    _assert_exactly_once(tb.dir, [0], T=2)


def test_lifecycle_close_idempotent_and_submit_after_close(tmp_path):
    gw = ProvingGateway(str(tmp_path / "never"), device="cpu")
    gw.close()
    gw.close()
    with pytest.raises(ServiceClosedError):
        gw.start()
    gw2 = _gateway(tmp_path / "real", n_workers=1)
    ta = _add(gw2, "alice", 11)
    wit = _wits(1, 11)[0]
    with pytest.raises(ValueError):
        gw2.submit("nobody", wit)
    with pytest.raises(ValueError):
        _add(gw2, "alice", 11)          # duplicate
    with pytest.raises(ValueError):
        _add(gw2, "../escape", 11)      # it becomes a directory name
    gw2.close(timeout=600)
    gw2.close(timeout=600)
    with pytest.raises(ServiceClosedError):
        gw2.submit("alice", wit)
    with pytest.raises(ServiceClosedError):
        _add(gw2, "late", 33)
    assert ta.stats["submitted"] == 0


def test_generator_cache_derives_each_label_once_under_threads(
        monkeypatch):
    """Pool workers share the per-label generator cache: many threads
    asking for one label at growing lengths must each get the same
    generators, derived once per missing index (a check-then-insert
    without the lock derives twice and can drop an extension)."""
    calls = []
    orig = group._kernel_derive

    def counted(label, start, n, device):
        calls.append((start, n))
        time.sleep(0.001)              # widen the race window
        return orig(label, start, n, device)

    monkeypatch.setattr(group, "_kernel_derive", counted)
    monkeypatch.setattr(group, "_GEN_CACHE", {})
    label, lengths = b"test/threads", [16, 64, 32, 128, 64, 16] * 4
    want = orig(label, 0, 128, torch.device("cpu"))
    got, errors = {}, []

    def worker(i, n):
        try:
            got[i] = group.derive_generators(label, n, "cpu")
        except Exception as exc:       # surfaced below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i, n))
                   for i, n in enumerate(lengths)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    for i, n in enumerate(lengths):
        assert torch.equal(got[i], want[:n])
    assert sum(n for _, n in calls) == 128      # every index once
