"""Chaos harness for the port's crash-safe prover service
(`repro_torch.launch.serve.ProverService`) on the CPU: the contracts of
tests/test_serve_chaos.py with the port's prover behind the service.

* a restarted service replays journaled steps and re-emits every
  non-dropped window,
* `verify_bytes` accepts every committed proof read back from disk,
* the manifest holds EXACTLY ONE ``COMMITTED`` line per window,
* journal segments are garbage-collected once their window is terminal.

Each fault point drives windows of T = 1 (the contract needs no more),
two of them: one before the fault and one after it.  Signal death is
driven for real too, through subprocess isolation with a ``kill``
action.  Also here: the two repairs the port makes to faults it shares
with the reference (the prove child's key cap, the warm-up stream)."""
import functools
import os

import numpy as np
import pytest
import torch

from repro.core import quantfc as rq

from repro_torch.core.pipeline import build_fcnn_graph, verify_bytes
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.proofio import ProofDecodeError, decode_vk
from repro_torch.core.quantfc import (QuantConfig,
                                      synthetic_sgd_trajectory_widths)
from repro_torch.launch import serve
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
    """Submit wits[start:]; returns the index where a submit-side crash
    surfaced (len(wits) = no crash)."""
    for i in range(start, len(wits)):
        try:
            service.submit(wits[i])
        except (SimulatedFailure, RuntimeError):
            return i
    return len(wits)


@functools.lru_cache(maxsize=None)
def _verified(vk_bytes: bytes, raw: bytes) -> bool:
    """`verify_bytes` is a pure function of its bytes: equal proofs of
    equal keys (the first window of most scenarios) verify once."""
    return verify_bytes(decode_vk(vk_bytes, device="cpu"), raw, label=LABEL)


def _assert_contract(out_dir, n_windows, dropped=()):
    """The chaos acceptance criteria, from disk state alone."""
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
    assert serve.journal_steps(serve.journal_dir(out)) == [], \
        "terminal windows left journal segments behind"


# ---------------------------------------------------------------------------
# Crash at every fault point -> restart -> exactly-once commit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [
    "submit/journal-pre@1",       # crash before the witness is durable
    "submit/journal-post@1",      # crash after journal, before enqueue
    "prove/mid@1",                # transient mid-prove failure (retried)
    "commit/pre-manifest@0",      # proof written, manifest commit lost
    "worker/kill@1",              # worker dies wholesale mid-pipeline
])
def test_crash_then_restart_commits_every_window_once(tmp_path, fault):
    wits = _wits(2)
    svc = _service(tmp_path, injector=FailureInjector.from_spec(fault))
    svc.start(warm=False)
    _drive(svc, wits)
    try:
        svc.close(timeout=600)
    except (SimulatedFailure, RuntimeError, TimeoutError):
        pass                      # worker-side faults surface here
    svc2 = _service(tmp_path)     # restart, fault-free: replay + resume
    svc2.start(warm=False)
    _drive(svc2, wits, start=min(svc2.next_step, len(wits)))
    svc2.close(timeout=600)
    _assert_contract(tmp_path, 2)
    if fault == "prove/mid@1":
        # the transient failure was retried in-place, not restarted
        assert serve.read_manifest(str(tmp_path))[1]["attempts"] == 2


def test_subprocess_isolation_survives_signal_death(tmp_path, monkeypatch):
    """Each prove attempt is a ``python -m repro_torch.launch.serve
    --prove-window`` child on the parent's device: the first SIGKILLs
    itself mid-prove (a genuine negative returncode), the supervisor
    retries, and the retry, seeing the cross-process once-marker,
    proves; the parent commits exactly once."""
    monkeypatch.setenv("ZKDL_FAULTS", "prove/mid@0:kill")
    monkeypatch.setenv("ZKDL_FAULTS_ONCE", str(tmp_path / "fired"))
    out = tmp_path / "out"
    svc = _service(out, isolation="subprocess", max_attempts=3,
                   backoff_base=0.1, prove_timeout=600)
    svc.start(warm=False)
    assert svc._child_argv(0)[-4:] == [
        "--device", "cpu", "--max-merged-len",
        str(max(1 << 22, svc.pk.cfg.merged_len))]
    svc.submit(_wits(1)[0])
    svc.close(timeout=600)
    _assert_contract(out, 1)
    assert serve.read_manifest(str(out))[0]["attempts"] == 2
    assert svc.stats["retries"] == 1


# ---------------------------------------------------------------------------
# The repairs of two faults shared with the reference
# ---------------------------------------------------------------------------

def test_child_decodes_its_key_under_the_cap_its_parent_passes(
        tmp_path, monkeypatch):
    """The reference's prove child decodes ``vk.bin`` under the default
    cap, 2^22, which a full-width key (merged length 2^28) is above, so
    it refuses its own key.  The port's parent passes the merged length
    of the key it wrote.  Here a small key stands for the full-width one
    and a cap below its length for 2^22: under that cap the child
    refuses, under the length its parent passes it proves."""
    svc = _service(tmp_path, injector=FailureInjector.from_spec(
        "worker/kill@0"))         # journal the window, prove nothing
    svc.start(warm=False)
    svc.submit(_wits(1)[0])
    with pytest.raises(SimulatedFailure):
        svc.close(timeout=600)
    merged = svc.pk.cfg.merged_len
    with open(tmp_path / "vk.bin", "rb") as f:
        vk_bytes = f.read()
    with pytest.raises(ProofDecodeError, match="refusing key derivation"):
        decode_vk(vk_bytes, max_merged_len=merged // 2)

    monkeypatch.setattr(serve.supervise, "hard_exit", lambda status: None)
    argv = ["--prove-window", "0", "--out-dir", str(tmp_path), "--seed",
            "5", "--label", LABEL.decode(), "--device", "cpu"]
    with pytest.raises(ProofDecodeError):
        serve.main(argv + ["--max-merged-len", str(merged // 2)])
    assert not (tmp_path / "proof_000000.bin").exists()
    assert serve.main(argv + ["--max-merged-len", str(merged)]) == 0
    with open(tmp_path / "proof_000000.bin", "rb") as f:
        assert _verified(vk_bytes, f.read())


def test_warm_up_stays_in_range_where_the_reference_stream_overflows():
    """The reference warms on its synthetic SGD stream (0.3-scaled
    weights, an SGD step of 2^-8), which leaves the Q-bit range at batch
    128: at widths (128, 64, 128) and T = 2 its second step's G_A' is the
    first value out of range.  The port's warm-up witnesses at that
    geometry pass preflight.  A CPU prove there takes minutes, so the
    port's `warm` proves and verifies here at widths (4, 4, 4) (phase
    `serve` of chip_smoke.py warms at width 4096, batch 128 on the
    card)."""
    from repro_torch.core.pipeline import compile
    from repro_torch.core.pipeline.api import warm_witnesses
    from repro_torch.launch.preflight import validate_witness

    widths, batch = (128, 64, 128), 128
    with pytest.raises(OverflowError, match="G_A'"):
        rq.synthetic_sgd_trajectory_widths(2, widths, batch,
                                           rq.QuantConfig(16, 4), seed=0)
    cfg = PipelineConfig.from_graph(build_fcnn_graph(widths, batch),
                                    q_bits=16, r_bits=4, n_steps=2)
    wits = warm_witnesses(cfg, 0, torch.device("cpu"))
    assert len(wits) == 2
    for wit in wits:
        validate_witness(cfg, wit)

    pk, _ = compile(build_fcnn_graph(WIDTHS, batch=2), QC, n_steps=2,
                    device="cpu")
    delta = pk.warm(seed=5)
    assert set(delta) == {"hits", "misses", "disk_hits", "disk_writes",
                          "disk_corrupt"}
    assert np.all([v == 0 for v in delta.values()])      # no card here
