"""The port's prover service under the rest of the contracts of
tests/test_serve_chaos.py: exhausted retries, backpressure, a dead
worker at close, trailing partial windows, a corrupt journal segment,
lifecycle edges, full-disk policies and manifest compaction, with the
port's prover behind the service and the fewest proves each contract
needs (windows of T = 1 unless the contract needs a partial window)."""
import functools
import json
import os
import time

import pytest
import torch

from repro_torch.core.pipeline import build_fcnn_graph, verify_bytes
from repro_torch.core.pipeline.proofio import decode_vk
from repro_torch.core.quantfc import (QuantConfig,
                                      synthetic_sgd_trajectory_widths)
from repro_torch.launch import serve
from repro_torch.launch.admission import ServiceClosedError
from repro_torch.launch.serve import ProverService
from repro_torch.train.resilience import FailureInjector, SimulatedFailure

QC = QuantConfig(q_bits=16, r_bits=4)
WIDTHS = (4, 4, 4)
LABEL = b"zkdl/train"


def _service(out_dir, T=1, **kw):
    return ProverService(build_fcnn_graph(WIDTHS, batch=2), QC, n_steps=T,
                         out_dir=str(out_dir), rng_seed=5, device="cpu",
                         **kw)


@functools.lru_cache(maxsize=None)
def _wits(n):
    return tuple(synthetic_sgd_trajectory_widths(n, WIDTHS, 2, QC, seed=5,
                                                 device="cpu"))


def _drive(service, wits, start=0):
    for i in range(start, len(wits)):
        try:
            service.submit(wits[i])
        except (SimulatedFailure, RuntimeError):
            return i
    return len(wits)


@functools.lru_cache(maxsize=None)
def _verified(vk_bytes: bytes, raw: bytes) -> bool:
    return verify_bytes(decode_vk(vk_bytes, device="cpu"), raw, label=LABEL)


def _assert_contract(out_dir, n_windows, dropped=()):
    out = str(out_dir)
    man = serve.read_manifest(out)
    counts = serve.manifest_commit_counts(out)
    with open(os.path.join(out, "vk.bin"), "rb") as f:
        vk_bytes = f.read()
    for w in range(n_windows):
        if w in dropped:
            assert man[w]["status"] == serve.DROPPED
            assert counts.get(w, 0) == 0
            continue
        assert man.get(w, {}).get("status") == serve.COMMITTED, \
            f"window {w}: {man.get(w)}"
        assert counts[w] == 1, f"window {w} committed {counts[w]} times"
        with open(os.path.join(out, f"proof_{w:06d}.bin"), "rb") as f:
            assert _verified(vk_bytes, f.read()), f"window {w} rejected"
    assert serve.journal_steps(serve.journal_dir(out)) == []


def test_exhausted_retries_mark_failed_and_keep_going(tmp_path):
    """Every attempt at window 0 fails -> FAILED in the manifest, and the
    worker proves window 1 instead of wedging the queue."""
    class FirstTwoHits(FailureInjector):
        def fire(self, point):
            self.counts[point] = self.counts.get(point, 0) + 1
            if point == "prove/mid" and self.counts[point] <= 2:
                raise SimulatedFailure(f"injected {point} "
                                       f"hit {self.counts[point]}")

    svc = _service(tmp_path, max_attempts=2, backoff_base=0.01,
                   injector=FirstTwoHits())
    svc.start(warm=False)
    for wit in _wits(2):
        svc.submit(wit)
    svc.close(timeout=600)
    man = serve.read_manifest(str(tmp_path))
    assert man[0]["status"] == serve.FAILED and man[0]["attempts"] == 2
    assert man[1]["status"] == serve.COMMITTED
    assert svc.stats["failed_windows"] == 1 and svc.stats["retries"] >= 1
    svc2 = _service(tmp_path)     # FAILED is terminal: resume after it
    svc2.start(warm=False)
    assert svc2.next_step == 2
    svc2.close()


def test_backpressure_drop_window_accounting(tmp_path):
    """A wedged prover with a bounded queue sheds the newest window:
    DROPPED in the manifest, journal GC'd, stats accounted, and
    training's submit() never blocks."""
    svc = _service(tmp_path, queue_size=1, backpressure="drop_window",
                   max_attempts=2, backoff_base=3.0, backoff_cap=3.0,
                   injector=FailureInjector.from_spec("prove/mid@0"))
    svc.start(warm=False)
    wits = _wits(3)
    svc.submit(wits[0])
    t0 = time.time()              # wait until the worker owns window 0
    while svc._queue.qsize() > 0 and time.time() - t0 < 600:
        time.sleep(0.01)
    time.sleep(0.3)               # ... and sleeps in its backoff
    svc.submit(wits[1])           # window 1 fills the queue
    svc.submit(wits[2])           # window 2 is dropped
    svc.close(timeout=600)
    assert svc.stats["dropped_windows"] == 1
    assert svc.stats["dropped_steps"] == 1
    _assert_contract(tmp_path, 3, dropped={2})
    assert serve.read_manifest(str(tmp_path))[2]["reason"] == "backpressure"


def test_close_handles_dead_worker_without_hanging(tmp_path):
    """close() after a worker death bounds its join, surfaces the
    original error, and leaves the journal for the next run."""
    svc = _service(tmp_path, max_attempts=1,
                   injector=FailureInjector.from_spec("worker/kill@0"))
    svc.start(warm=False)
    wits = _wits(1)
    _drive(svc, wits)
    with pytest.raises(SimulatedFailure):
        svc.close(timeout=60)
    assert serve.journal_steps(serve.journal_dir(str(tmp_path))) == [0]
    svc2 = _service(tmp_path)
    svc2.start(warm=False)
    _drive(svc2, wits, start=min(svc2.next_step, len(wits)))
    svc2.close(timeout=600)
    _assert_contract(tmp_path, 1)


def test_partial_trailing_window_reported_not_discarded(tmp_path):
    """A trailing window short of T steps is PARTIAL (stats + manifest)
    with its journal retained; the restarted service finishes it."""
    svc = _service(tmp_path, T=2)
    svc.start(warm=False)
    wits = _wits(4)
    for wit in wits[:3]:          # 1 full window + 1 trailing step
        svc.submit(wit)
    svc.close(timeout=600)
    man = serve.read_manifest(str(tmp_path))
    assert man[0]["status"] == serve.COMMITTED
    assert man[1]["status"] == serve.PARTIAL
    assert man[1]["n_steps"] == 1 and man[1]["of"] == 2
    assert svc.stats["partial_steps"] == 1
    assert serve.journal_steps(serve.journal_dir(str(tmp_path))) == [2]
    svc2 = _service(tmp_path, T=2)
    svc2.start(warm=False)
    assert svc2.next_step == 3
    svc2.submit(wits[3])
    svc2.close(timeout=600)
    _assert_contract(tmp_path, 2)


def test_corrupt_journal_segment_fails_window_not_service(tmp_path):
    """A torn journal segment marks ITS window FAILED on recovery; the
    service still starts and proves new windows."""
    svc = _service(tmp_path, T=2)
    svc.start(warm=False)
    wits = _wits(4)
    svc.submit(wits[0])
    svc.close(timeout=600)        # window 0 PARTIAL, step 0 journaled
    seg = os.path.join(serve.journal_dir(str(tmp_path)), "step_00000000.npz")
    with open(seg, "r+b") as f:
        f.truncate(max(1, os.path.getsize(seg) // 3))
    svc2 = _service(tmp_path, T=2)
    svc2.start(warm=False)
    man = serve.read_manifest(str(tmp_path))
    assert man[0]["status"] == serve.FAILED
    assert "journal" in man[0]["error"]
    assert svc2.next_step == 2    # FAILED window is terminal
    for wit in wits[2:]:
        svc2.submit(wit)
    svc2.close(timeout=600)
    assert serve.read_manifest(str(tmp_path))[1]["status"] == serve.COMMITTED


def test_close_is_idempotent_and_submit_after_close_raises(tmp_path):
    cold = _service(tmp_path / "cold")
    cold.close()                  # never started
    cold.close()                  # already closed
    with pytest.raises(ServiceClosedError):
        cold.start(warm=False)

    svc = _service(tmp_path / "hot")
    svc.start(warm=False)
    wit = _wits(1)[0]
    svc.submit(wit)
    svc.close(timeout=600)
    svc.close(timeout=600)        # idempotent after a real run
    with pytest.raises(ServiceClosedError):
        svc.submit(wit)
    _assert_contract(tmp_path / "hot", 1)
    svc2 = _service(tmp_path / "hot")   # the lock was released once
    svc2.start(warm=False)
    svc2.close(timeout=600)


def test_service_journal_enospc_block_retries_then_drop_drops(tmp_path):
    """``block`` retries a transient ENOSPC at the journal write
    transparently; ``drop_window`` turns it into a terminal DROPPED
    window."""
    svc = _service(tmp_path / "block", backoff_base=0.01,
                   injector=FailureInjector.from_spec(
                       "storage/journal@0:enospc"))
    svc.start(warm=False)
    svc.submit(_wits(1)[0])
    svc.close(timeout=600)
    assert svc.stats["storage_errors"] == 1
    _assert_contract(tmp_path / "block", 1)

    svc = _service(tmp_path / "drop", backpressure="drop_window",
                   injector=FailureInjector.from_spec(
                       "storage/journal@0:enospc"))
    svc.start(warm=False)
    for wit in _wits(2):
        svc.submit(wit)           # never raises under drop_window
    svc.close(timeout=600)
    man = serve.read_manifest(str(tmp_path / "drop"))
    assert man[0]["status"] == serve.DROPPED
    assert man[0]["reason"] == "storage"
    assert svc.stats["dropped_windows"] == 1
    _assert_contract(tmp_path / "drop", 2, dropped={0})


def test_compact_manifest_preserves_replay_semantics(tmp_path):
    """Compaction is invisible to every reader: last-wins resolution,
    the exactly-once audit, and no-window lines all survive."""
    lines = [
        {"window": 0, "status": serve.FAILED, "reason": "prove"},
        {"window": 0, "status": serve.COMMITTED, "n_steps": 2},
        {"event": "DATASET_BINDING", "root": "aa" * 16},
        {"window": 1, "status": serve.COMMITTED, "n_steps": 2},
        {"window": 1, "status": serve.COMMITTED, "n_steps": 2},  # double!
        {"window": 2, "status": serve.PARTIAL, "n_steps": 1, "of": 2},
        {"window": 3, "status": serve.FAILED, "reason": "deadline"},
        {"window": 3, "status": serve.FAILED, "reason": "prove"},
    ]
    path = os.path.join(str(tmp_path), serve.MANIFEST)
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
        f.write('{"window": 9, "status": "COMM')   # torn final append
    before_man = serve.read_manifest(str(tmp_path))
    before_counts = serve.manifest_commit_counts(str(tmp_path))
    info = serve.compact_manifest(str(tmp_path))
    assert serve.read_manifest(str(tmp_path)) == before_man
    assert serve.manifest_commit_counts(str(tmp_path)) == before_counts
    assert before_counts[1] == 2
    assert info == {"lines_before": 8, "lines_after": 6, "windows": 4}
    with open(path) as f:
        kept = [json.loads(ln) for ln in f if ln.strip()]
    assert {"event": "DATASET_BINDING", "root": "aa" * 16} in kept
    assert kept[-1]["window"] == 3


def test_service_start_auto_compacts_oversized_manifest(tmp_path):
    path = os.path.join(str(tmp_path), serve.MANIFEST)
    with open(path, "w") as f:
        for i in range(40):
            f.write(json.dumps({"window": 0, "status": serve.FAILED,
                                "reason": "prove", "attempt": i}) + "\n")
        f.write(json.dumps({"window": 0, "status": serve.COMMITTED,
                            "n_steps": 1}) + "\n")
    svc = _service(tmp_path, compact_threshold=5)
    svc.start(warm=False)
    assert svc.next_step == 1
    assert serve.manifest_line_count(str(tmp_path)) == 1
    assert serve.manifest_commit_counts(str(tmp_path)) == {0: 1}
    svc.close(timeout=600)


def test_cli_flags_and_default_device(capsys):
    """The CLI takes every flag of the reference's plus ``--device`` and
    the child's ``--max-merged-len``; without ``--device`` the service
    wants the card and raises where there is none."""
    import re

    from repro.launch import serve as ref_serve

    def flags(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))

    port, ref = flags(serve.main), flags(ref_serve.main)
    assert ref <= port
    assert port - ref == {"--device", "--max-merged-len"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ProverService(build_fcnn_graph(WIDTHS, batch=2), QC)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.ProvingGateway("unused")
