"""Crash-safe proving: a resident single-config service and a
multi-tenant gateway on one durability contract.

The reference's service layer (`repro.launch.serve`) with the port's
prover behind it: the same classes, journal and manifest layout, fault
points, CLI flags and proof bytes, on the card unless the caller asks
for ``device="cpu"`` (``--device cpu``).  Journal segments are the
reference's npz layout, so either package replays the other's; a
subprocess prove child gets ``--device`` and the merged key length its
``vk.bin`` declares (``--max-merged-len``) in its argv.

Two entry points share this module's journal/manifest machinery:

`ProverService`
    One (graph, quant, T) config, one worker thread, one out_dir —
    compile once, prove windows forever.  The prover's one-time costs
    (generator derivation on the card, the kernel libraries' build or
    load, first launches) are paid at `start()`; the built libraries
    stay on disk (`repro_torch.core.execache`), so a RESTARTED service
    for the same config builds nothing.

`ProvingGateway`
    Many named tenants, one shared pool of N supervised prove workers
    draining a weighted-fair admission queue
    (`launch/admission.WeightedFairQueue`).  Each tenant lives under
    ``<out_dir>/tenants/<name>/`` with its OWN vk.bin, journal,
    manifest and proof files — byte-compatible with a single
    `ProverService` out_dir, so `verify_bytes`, the membership audit
    and the recovery protocol below apply per tenant unchanged.

Gateway control plane
=====================

Admission
    ``submit(tenant, wit)`` PREFLIGHT-validates the witness against the
    tenant's key geometry (`launch/preflight.validate_witness`: shapes,
    dtypes, quantization ranges, eq. (3)/(5) decompositions, skip
    topology, step monotonicity) and rejects malformed input with typed
    `WitnessValidationError`\\ s BEFORE any byte is journaled.  Valid
    steps journal durably, then full windows enter the weighted-fair
    queue: dispatch is stride-scheduled by tenant weight (a flooding
    tenant cannot starve the rest), and when a ``queue_windows`` bound
    saturates, the newest window of the lowest-priority backlogged
    tenant is load-shed — terminal ``SHED`` manifest line, journal
    GC'd, counted in its stats — never silently lost.

Deadlines
    A tenant's ``deadline_s`` stamps each window at admission; a window
    still queued past its deadline is marked ``FAILED`` with reason
    ``deadline`` at dispatch (the worker is immediately free for live
    work).  Under subprocess isolation the remaining budget also bounds
    the child's wall clock.

Circuit breaker
    ``breaker_threshold`` consecutive prove failures trip a tenant to
    degraded journal-only mode: its windows PARK in memory (journal
    retained — durability is never degraded) instead of burning pool
    capacity.  After ``breaker_reset_s`` the breaker half-opens and
    releases ONE probe window; success re-closes it and unparks the
    backlog, failure re-opens it.

Worker pool
    Workers run window proves under `launch/supervise` (thread or
    subprocess isolation).  A monitor thread respawns dead workers and
    requeues the job a dead worker held at the FRONT of its tenant's
    queue; before re-proving, workers re-check the tenant manifest, so
    a worker that died after its COMMITTED line cannot double-commit.
    A job that kills workers repeatedly is marked ``FAILED`` (reason
    ``worker-death``) rather than crash-looping the pool.

Single ownership
    `start()` takes an advisory lockfile (``GATEWAY.lock``) on out_dir;
    a second gateway (or service) on the same directory raises
    `GatewayBusyError` while the owner is alive, and steals the lock
    when the recorded pid is dead.  ``status()`` (live) and
    `dir_status` / ``--status`` (from disk) expose queue depths,
    breaker states, worker liveness and per-tenant commit/failed/
    dropped/shed counters.  ``close()`` drains gracefully: every queued
    window proves, trailing partials get PARTIAL lines, the lock is
    released; close is idempotent and a later submit raises
    `ServiceClosedError`.

Storage failures
    Every durable write (journal npz, proof bin, manifest line) that
    hits an `OSError` surfaces as `train/checkpoint.StorageError` with
    no ``*.tmp`` orphan left behind.  Journal writes retry with backoff
    under ``backpressure="block"`` (then raise — nothing half-durable)
    or terminally DROP the window under ``drop_window``; proof/manifest
    write failures mark the window FAILED (reason ``storage``) or leave
    it non-terminal for restart re-prove — the worker loop never
    crashes on a full disk.

Durability contract
===================

The service never loses a submitted witness to a crash, and never
commits a window twice — and the gateway holds the same invariant PER
TENANT across worker deaths, SIGKILL, ENOSPC and restarts (the chaos
suites drive every fault point and assert it).  Concretely:

Journal (write-ahead witness log)
    ``submit()`` appends the step witness to
    ``<out_dir>/journal/step_<s>.npz`` (atomic tmp+rename, the
    `train/checkpoint.atomic_write_bytes` pattern) BEFORE enqueueing it
    for the worker.  Step indices ``s`` are global and monotonic; window
    ``w`` owns steps ``[w*T, (w+1)*T)``.  A journal segment is
    garbage-collected only after its window reaches a terminal manifest
    state (``COMMITTED`` or ``DROPPED``).

Manifest (append-only commit log)
    ``<out_dir>/MANIFEST.jsonl``: one JSON line per event, fsync'd.
    Per-window status is LAST-WINS on read; a torn trailing line (crash
    mid-append) is skipped, not an error.  States:

    * ``COMMITTED`` — ``proof_<w>.bin`` is durable and verified-sized;
      written AFTER the atomic proof write, so a committed line implies
      readable proof bytes.
    * ``FAILED``    — every supervised prove attempt failed (or the
      journal for the window was corrupt/gapped); the service keeps
      going instead of wedging.
    * ``DROPPED``   — backpressure policy ``drop_window`` shed the
      window; its journal steps are GC'd and accounted in ``stats``.
    * ``PARTIAL``   — informational: close() drained with a trailing
      window short of T steps.  Its journal steps are RETAINED; a
      restarted service resumes the window (a later ``COMMITTED`` line
      supersedes it).

Restart / replay protocol
    ``start()`` on a non-empty out_dir: read the manifest, delete
    leftover ``*.tmp.*`` turds, GC journal steps of terminal windows,
    then replay the remaining journaled steps (complete un-committed
    windows and the trailing partial window) into the prove queue in
    order.  New submissions continue at
    ``next_step = max(highest journaled step + 1,
    (highest manifest window + 1) * T)``.  A proof file without a
    manifest line (crash between proof write and commit) is re-proved
    and overwritten — the manifest, not the file system, is the source
    of truth, which is what keeps "exactly one COMMITTED line per
    window" true under crashes at every fault point.

Supervised proving
    Each window proves under `launch/supervise.run_supervised`
    (``isolation="thread"``: in-process attempts, capped exponential
    backoff) or `run_subprocess_supervised` (``isolation="subprocess"``:
    each attempt is a fresh ``python -m repro_torch.launch.serve
    --prove-window w`` child that rebuilds the ProvingKey (its kernel
    libraries load from the build cache), proves from the journal,
    atomically writes the proof, and hard-exits — signal deaths and
    timeouts retry, clean rejections don't).  Repeated failure marks
    the window ``FAILED``; the worker moves on.

Backpressure
    ``queue_size=0`` (default) keeps the historical unbounded queue.
    With a bound, policy ``block`` makes submit() wait (checking worker
    liveness so a dead worker raises instead of deadlocking), policy
    ``drop_window`` sheds the NEWEST window on overflow: mark
    ``DROPPED``, GC its journal, count it in
    ``stats["dropped_windows"]``, and ignore the window's remaining
    submissions.

Fault injection
    Pass a `train/resilience.FailureInjector` (or set ``ZKDL_FAULTS``
    for the CLI/subprocess workers).  Fault points: ``submit/journal-pre``,
    ``submit/journal-post``, ``prove/mid``, ``commit/pre-manifest``,
    ``worker/kill``.  The chaos tests drive every point and assert the
    contract above.

Layout of the output directory (created on start):

    GATEWAY.lock        advisory owner lock (pid + timestamp JSON)
    vk.bin              the serialized VerifyingKey (a few hundred bytes)
    proof_000000.bin    aggregated proof for window 0 (v3 byte format)
    MANIFEST.jsonl      append-only commit log (see above)
    journal/            write-ahead step witnesses (empty when idle)
    tenants/<name>/     gateway mode: one full sub-layout (vk.bin,
                        proofs, MANIFEST.jsonl, journal/) per tenant

Training never blocks on proving (default config): `submit(wit)`
journals + enqueues a step witness and returns; the background worker
assembles full windows, proves, and streams `proof_NNNNNN.bin` files.

    service = ProverService(graph, quant, n_steps=T, out_dir="proofs/")
    service.start()                       # warm keys, replay journal
    for step in range(service.next_step, n):
        ws, wit = train_step(ws, batch)   # training thread
        service.submit(wit)               # journaled, non-blocking
    service.close()                       # drain remaining full windows

CLI (drives a synthetic trajectory; doubles as the chaos smoke):

    python -m repro_torch.launch.serve --widths 4,4,4 --batch 2 \
        --window 2 --steps 4 --out-dir /tmp/proofs [--device cpu] \
        [--warm-only] [--inject point@HITS[:action],...] [--isolation ...]

    # multi-tenant gateway: 2 tenants, pool of 2 workers
    python -m repro_torch.launch.serve --tenants alice:2,bob --pool 2 \
        --steps 4 --window 2 --out-dir /tmp/gw

    # from-disk health snapshot (runbook entry point)
    python -m repro_torch.launch.serve --status --out-dir /tmp/gw

Operator runbook: see "Operating the gateway" in
src/repro/core/pipeline/README.md (symptom -> manifest state ->
action table).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import io
import json
import os
import queue
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.launch import supervise
from repro_torch.launch.admission import (CircuitBreaker, GatewayBusyError,
                                          ServiceClosedError,
                                          WeightedFairQueue,
                                          acquire_dir_lock, release_dir_lock)
from repro_torch.launch.preflight import (WitnessValidationError,
                                          check_step_monotonic,
                                          validate_witness)

MANIFEST = "MANIFEST.jsonl"
JOURNAL_DIR = "journal"
TENANTS_DIR = "tenants"

COMMITTED = "COMMITTED"
FAILED = "FAILED"
DROPPED = "DROPPED"
SHED = "SHED"
PARTIAL = "PARTIAL"

#: manifest states after which a window will never be (re)proved
TERMINAL_STATES = (COMMITTED, DROPPED, SHED, FAILED)
#: terminal states whose journal segments are GC'd on recovery
GC_STATES = (COMMITTED, DROPPED, SHED)

# StepWitness list fields and their lengths as a function of the layer
# count L (scalars x/y and the skips dict are handled separately)
_WIT_LISTS = ("w", "z", "zpp", "b", "rz", "a", "gz", "ga", "gap", "rga",
              "gw")


# ---------------------------------------------------------------------------
# Witness journal
# ---------------------------------------------------------------------------

def journal_dir(out_dir: str) -> str:
    return os.path.join(out_dir, JOURNAL_DIR)


def _step_path(jdir: str, step: int) -> str:
    return os.path.join(jdir, f"step_{step:08d}.npz")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def journal_append(jdir: str, step: int, wit) -> str:
    """Durably persist one step witness (atomic tmp+rename npz): every
    tensor copied to the host, in the reference's layout (the same keys,
    dtypes and ``meta`` JSON)."""
    from repro_torch.train.checkpoint import atomic_write_bytes

    os.makedirs(jdir, exist_ok=True)
    arrays = {"x": _host(wit.x), "y": _host(wit.y)}
    lens = {}
    for field in _WIT_LISTS:
        vals = getattr(wit, field)
        lens[field] = len(vals)
        for i, arr in enumerate(vals):
            arrays[f"{field}.{i}"] = _host(arr)
    meta = {"q_bits": wit.cfg.q_bits, "r_bits": wit.cfg.r_bits,
            "lens": lens,
            "skips": sorted((int(k), int(v)) for k, v in wit.skips.items())}
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    path = _step_path(jdir, step)
    atomic_write_bytes(path, buf.getvalue())
    return path


def journal_load(jdir: str, step: int, device=None):
    """Reconstruct a StepWitness from its journal segment, its tensors on
    ``device`` (None: the card).  Raises on a missing/corrupt segment —
    callers decide the failure policy."""
    from repro_torch.core.quantfc import QuantConfig, StepWitness

    dev = resolve_device(device)

    def load(z, key):
        return torch.as_tensor(np.asarray(z[key]), device=dev)

    with np.load(_step_path(jdir, step)) as z:
        meta = json.loads(bytes(bytearray(np.asarray(z["meta"]))).decode())
        lists = {f: [load(z, f"{f}.{i}") for i in range(meta["lens"][f])]
                 for f in _WIT_LISTS}
        return StepWitness(
            cfg=QuantConfig(q_bits=meta["q_bits"], r_bits=meta["r_bits"]),
            x=load(z, "x"), y=load(z, "y"),
            skips={int(k): int(v) for k, v in meta["skips"]},
            **lists)


def journal_steps(jdir: str) -> List[int]:
    """Sorted step indices with a committed (fully renamed) segment."""
    if not os.path.isdir(jdir):
        return []
    out = []
    for f in os.listdir(jdir):
        if f.startswith("step_") and f.endswith(".npz"):
            try:
                out.append(int(f[5:-4]))
            except ValueError:
                pass
    return sorted(out)


def journal_gc(jdir: str, lo: int, hi: int) -> None:
    """Delete journal segments for steps in [lo, hi)."""
    for s in range(lo, hi):
        try:
            os.remove(_step_path(jdir, s))
        except FileNotFoundError:
            pass


def _clean_tmp_files(out_dir: str) -> None:
    """Remove torn-write turds (``*.tmp.*``) left by a crashed writer."""
    for root in (out_dir, journal_dir(out_dir)):
        if not os.path.isdir(root):
            continue
        for f in os.listdir(root):
            if ".tmp." in f:
                try:
                    os.remove(os.path.join(root, f))
                except OSError:
                    pass


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------

def read_manifest(out_dir: str) -> Dict[int, dict]:
    """Last-wins view of MANIFEST.jsonl keyed by window.  Unparseable
    (torn) lines are skipped: a crash mid-append loses at most the event
    being written, never the file."""
    path = os.path.join(out_dir, MANIFEST)
    out: Dict[int, dict] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "window" in rec:
                out[int(rec["window"])] = rec
    return out


def manifest_commit_counts(out_dir: str) -> Dict[int, int]:
    """COMMITTED lines per window — the exactly-once audit."""
    path = os.path.join(out_dir, MANIFEST)
    counts: Dict[int, int] = {}
    if not os.path.exists(path):
        return counts
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("status") == COMMITTED:
                w = int(rec["window"])
                counts[w] = counts.get(w, 0) + 1
    return counts


def manifest_line_count(out_dir: str) -> int:
    path = os.path.join(out_dir, MANIFEST)
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        return sum(1 for line in f if line.strip())


def compact_manifest(out_dir: str) -> dict:
    """Rewrite MANIFEST.jsonl keeping only the lines its readers can
    still observe, via the same tmp+rename+fsync discipline as every
    other durable write.  Replay semantics are UNCHANGED:

    * per window, the LAST line is kept (that is what `read_manifest`
      last-wins resolves to) plus every COMMITTED line — so
      `manifest_commit_counts`, the exactly-once audit, is preserved
      byte-for-byte even for the pathological double-commit it exists
      to catch;
    * lines WITHOUT a ``window`` key (e.g. the membership audit's
      DATASET_BINDING events) are kept verbatim, in order;
    * torn/unparseable lines are dropped — readers already skip them,
      and compaction is the natural point to shed them.

    Returns ``{"lines_before", "lines_after", "windows"}``.  A service
    run compacts automatically at start when the manifest exceeds its
    ``compact_threshold`` — a long-lived window cadence appends
    FAILED/retry/PARTIAL history forever, and replaying a multi-million
    line manifest on every restart is recovery-time debt."""
    from repro_torch.train.checkpoint import atomic_write_bytes

    path = os.path.join(out_dir, MANIFEST)
    if not os.path.exists(path):
        return {"lines_before": 0, "lines_after": 0, "windows": 0}
    entries = []                # (idx, window_or_None, status, text)
    with open(path) as f:
        for idx, line in enumerate(f):
            text = line.strip()
            if not text:
                continue
            try:
                rec = json.loads(text)
            except json.JSONDecodeError:
                continue                  # torn line: shed at compaction
            if isinstance(rec, dict) and "window" in rec:
                entries.append((idx, int(rec["window"]),
                                rec.get("status"), text))
            else:
                entries.append((idx, None, None, text))
    last_per_window: Dict[int, int] = {}
    for idx, w, _status, _text in entries:
        if w is not None:
            last_per_window[w] = idx
    keep = []
    for idx, w, status, text in entries:
        if w is None or status == COMMITTED or last_per_window[w] == idx:
            keep.append(text)
    atomic_write_bytes(path, ("\n".join(keep) + "\n").encode()
                       if keep else b"")
    return {"lines_before": len(entries), "lines_after": len(keep),
            "windows": len(last_per_window)}


def recover_journal_dir(out_dir: str, T: int, manifest: Dict[int, dict],
                        append, device=None
                        ) -> Tuple[List[Tuple[int, object]], int]:
    """Shared restart/replay protocol for one service/tenant directory:
    GC journal segments of terminal windows, mark gapped/corrupt windows
    FAILED via ``append`` (which must also update ``manifest``), load
    the replayable steps onto ``device``, and compute ``next_step``.
    Returns ``(replay, next_step)`` with ``replay`` ordered by step."""
    jdir = journal_dir(out_dir)
    steps = journal_steps(jdir)
    terminal = {w for w, rec in manifest.items()
                if rec.get("status") in GC_STATES}
    live = []
    for s in steps:
        if s // T in terminal:
            journal_gc(jdir, s, s + 1)   # crash between commit and GC
        else:
            live.append(s)
    # a PARTIAL window is non-terminal (its steps replay below), so
    # only terminal windows push next_step past their range
    max_terminal_w = max(
        (w for w, rec in manifest.items()
         if rec.get("status") in TERMINAL_STATES),
        default=-1)
    next_step = max([0, (max_terminal_w + 1) * T]
                    + [s + 1 for s in steps])
    by_window: Dict[int, List[int]] = {}
    for s in live:
        by_window.setdefault(s // T, []).append(s)
    replay: List[Tuple[int, object]] = []
    for w in sorted(by_window):
        ss = sorted(by_window[w])
        complete = ss == list(range(w * T, (w + 1) * T))
        tail = (w == max(by_window)
                and ss == list(range(w * T, w * T + len(ss))))
        if not (complete or tail):
            # a gap inside a non-trailing window: unprovable
            append({"window": w, "status": FAILED,
                    "error": "journal gap", "steps": ss})
            journal_gc(jdir, w * T, (w + 1) * T)
            continue
        loaded = []
        try:
            for s in ss:
                loaded.append((s, journal_load(jdir, s, device)))
        except Exception as exc:
            append({"window": w, "status": FAILED,
                    "error": f"journal corrupt: {exc}"})
            journal_gc(jdir, w * T, (w + 1) * T)
            continue
        replay.extend(loaded)
    # windows FAILED during this scan (gap/corrupt) are terminal too:
    # resume training after them, not inside them
    max_terminal_w = max(
        (w for w, rec in manifest.items()
         if rec.get("status") in TERMINAL_STATES),
        default=-1)
    next_step = max(next_step, (max_terminal_w + 1) * T)
    return replay, next_step


# ---------------------------------------------------------------------------
# Service
# ---------------------------------------------------------------------------

class ProverService:
    """Crash-safe warm resident prover for ONE (graph, quant, T) config.

    ``device`` (None: the card) holds the keys and every prove; submitted
    witnesses should live there too (replayed ones are loaded there).

    Thread model: `submit()` is called from the training thread; it
    journals the witness, then enqueues it.  The internal worker thread
    owns every ProofSession and does all proving/manifest IO (manifest
    appends share a lock with the submit path's DROPPED records).
    `stats` and `proofs` are safe to read at any time."""

    FAULT_POINTS = ("submit/journal-pre", "submit/journal-post",
                    "prove/mid", "commit/pre-manifest", "worker/kill",
                    "storage/journal", "storage/proof", "storage/manifest",
                    "lock/acquire")

    def __init__(self, graph, quant=None, n_steps: int = 1,
                 out_dir: str = "proofs", label: bytes = b"zkdl/train",
                 verify: bool = False, rng_seed: int = 0, *,
                 journal: bool = True, queue_size: int = 0,
                 backpressure: str = "block", max_attempts: int = 3,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 prove_timeout: Optional[float] = None,
                 isolation: str = "thread",
                 compact_threshold: int = 10000,
                 injector=None, device=None):
        if backpressure not in ("block", "drop_window"):
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        if isolation not in ("thread", "subprocess"):
            raise ValueError(f"unknown isolation mode {isolation!r}")
        self.device = resolve_device(device)
        self.graph = graph
        self.quant = quant
        self.n_steps = n_steps
        self.out_dir = out_dir
        self.label = label
        self.verify = verify
        self.rng_seed = rng_seed
        self.journal = journal
        self.backpressure = backpressure
        self.max_attempts = max_attempts
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.prove_timeout = prove_timeout
        self.isolation = isolation
        self.compact_threshold = compact_threshold
        self.injector = injector
        self.pk = None
        self.vk = None
        self.proofs: List[Tuple[int, str, int, float]] = []
        self.warm_stats: Optional[dict] = None
        self.warm_seconds: float = 0.0
        self.stats = {"submitted": 0, "journaled": 0, "replayed": 0,
                      "proved": 0, "failed_windows": 0, "retries": 0,
                      "dropped_windows": 0, "dropped_steps": 0,
                      "partial_steps": 0, "storage_errors": 0}
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._worker: Optional[threading.Thread] = None
        self._errors: list = []
        self._mlock = threading.Lock()
        self._manifest: Dict[int, dict] = {}
        self._dropped: set = set()
        self._next_step = 0
        self._closed = False
        self._lock_path: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self, warm: bool = True) -> "ProverService":
        """Compile keys (optionally warming every kernel with a throwaway
        prove), write vk.bin, recover journal/manifest state, replay
        unproved windows, and launch the proving worker."""
        from repro_torch.core import execache
        from repro_torch.core.pipeline import compile as zk_compile
        from repro_torch.train.checkpoint import atomic_write_bytes

        if self._closed:
            raise ServiceClosedError("service already closed")
        os.makedirs(self.out_dir, exist_ok=True)
        self._lock_path = acquire_dir_lock(self.out_dir,
                                           injector=self.injector)
        try:
            _clean_tmp_files(self.out_dir)
            if (self.compact_threshold
                    and manifest_line_count(self.out_dir)
                    > self.compact_threshold):
                compact_manifest(self.out_dir)
            t0 = time.perf_counter()
            self.pk, self.vk = zk_compile(self.graph, self.quant,
                                          n_steps=self.n_steps,
                                          device=self.device)
            if warm:
                before = execache.stats()
                self.pk.warm(seed=self.rng_seed)
                after = execache.stats()
                self.warm_stats = {k: after[k] - before[k] for k in after}
                _release_cached_memory(self.device)
            self.warm_seconds = time.perf_counter() - t0
            atomic_write_bytes(os.path.join(self.out_dir, "vk.bin"),
                               self.vk.to_bytes())
            self._manifest = read_manifest(self.out_dir)
            self._dropped = {w for w, rec in self._manifest.items()
                             if rec.get("status") in (DROPPED, SHED)}
            replay = self._recover_journal() if self.journal else []
        except BaseException:
            release_dir_lock(self._lock_path)
            self._lock_path = None
            raise
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="zkdl-prover")
        self._worker.start()
        for step, wit in replay:
            self._queue.put((step, wit))    # durable steps never drop
            self.stats["replayed"] += 1
        return self

    @property
    def next_step(self) -> int:
        """Global index the next submit() will journal under — after a
        restart this is where training should resume."""
        return self._next_step

    def submit(self, wit) -> None:
        """Journal + queue one step witness.  Non-blocking with the
        default unbounded queue; under a bound, behavior follows the
        backpressure policy.  Raises if the worker has died (its original
        error chained) — the journal retains the step for a restart.

        A `StorageError` from the journal write (ENOSPC, IO error) is
        retried with backoff under ``backpressure="block"`` (then raised
        if the disk stays full — nothing was enqueued, nothing is
        half-durable); under ``drop_window`` the window is terminally
        DROPPED with reason ``storage`` instead."""
        if self._closed:
            raise ServiceClosedError(
                "submit() after close(): the service accepts no new work")
        if self._worker is None:
            raise RuntimeError("service not started")
        self._check_worker()
        step = self._next_step
        window = step // self.n_steps
        self.stats["submitted"] += 1
        if self.injector is not None:
            self.injector.fire("submit/journal-pre")
        if self.journal:
            if not self._journal_step(window, step, wit):
                self._next_step = step + 1
                return                  # window terminally DROPPED
            self.stats["journaled"] += 1
        if self.injector is not None:
            self.injector.fire("submit/journal-post")
        self._next_step = step + 1
        if window in self._dropped:
            self.stats["dropped_steps"] += 1
            if self.journal:
                journal_gc(journal_dir(self.out_dir), step, step + 1)
            return
        item = (step, wit)
        if self.backpressure == "drop_window" and self._queue.maxsize > 0:
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                self._drop_window(window, step)
            return
        while True:
            try:
                self._queue.put(item, timeout=0.2)
                return
            except queue.Full:
                self._check_worker()

    def _journal_step(self, window: int, step: int, wit) -> bool:
        """Durably journal one step, applying the storage-failure policy.
        Returns False when the window was dropped (``drop_window`` under
        a persistent `StorageError`); raises under ``block`` when the
        retries are exhausted."""
        from repro_torch.train.checkpoint import StorageError

        jdir = journal_dir(self.out_dir)

        def write():
            if self.injector is not None:
                self.injector.fire("storage/journal")
            journal_append(jdir, step, wit)

        if self.backpressure == "block":
            res = supervise.run_supervised(
                write, max_attempts=self.max_attempts,
                backoff_base=self.backoff_base,
                backoff_cap=self.backoff_cap, retry_on=(StorageError,))
            self.stats["storage_errors"] += res.n_attempts - (1 if res.ok
                                                              else 0)
            if not res.ok:
                raise res.error
            return True
        try:
            write()
            return True
        except StorageError as exc:
            self.stats["storage_errors"] += 1
            self._drop_window(window, step, reason="storage",
                              error=str(exc))
            return False

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain queued FULL windows and stop the worker.  A trailing
        partial window is reported as PARTIAL in stats/manifest and its
        journal segments are retained for the next service run.  Never
        hangs on a dead worker: the sentinel is best-effort, the join is
        bounded, and the worker's original error is re-raised.

        Idempotent: closing a never-started or already-closed service is
        a no-op (a later ``submit()`` raises `ServiceClosedError`).  The
        directory lock is released on every exit path except a live
        worker still draining past ``timeout`` (the TimeoutError case —
        the worker keeps running, so the directory is still owned)."""
        if self._closed:
            return
        if self._worker is None:
            self._closed = True
            self._release_lock()
            return
        while True:
            try:
                self._queue.put(None, timeout=0.2)
                break
            except queue.Full:
                if not self._worker.is_alive():
                    break               # dead worker: nothing will drain
        self._worker.join(timeout)
        if self._worker.is_alive():
            raise TimeoutError(
                f"prover worker did not drain within {timeout}s "
                f"({self._queue.qsize()} items still queued; the journal "
                f"retains every submitted step)")
        self._worker = None
        self._closed = True
        self._release_lock()
        if self._errors:
            raise self._errors[0]

    def _release_lock(self) -> None:
        if self._lock_path is not None:
            release_dir_lock(self._lock_path)
            self._lock_path = None

    @property
    def n_proofs(self) -> int:
        return len(self.proofs)

    # -- internal ----------------------------------------------------------

    def _check_worker(self) -> None:
        if self._errors:
            raise RuntimeError(
                "prover worker died; journaled steps will replay on "
                "restart") from self._errors[0]
        if self._worker is not None and not self._worker.is_alive():
            raise RuntimeError("prover worker is not running")

    def _manifest_append(self, rec: dict) -> None:
        if self.injector is not None:
            self.injector.fire("storage/manifest")
        with self._mlock:
            with open(os.path.join(self.out_dir, MANIFEST), "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._manifest[int(rec["window"])] = rec

    def _manifest_append_safe(self, rec: dict) -> bool:
        """Manifest append that survives a full disk: a `StorageError`
        (injected or real OSError at the append) is counted, the record
        stays unwritten, and the caller keeps going — the window simply
        has no terminal line yet, so a restart re-derives its fate from
        the journal (the manifest stays the source of truth precisely
        because we never fake a line we could not fsync)."""
        from repro_torch.train.checkpoint import StorageError

        try:
            self._manifest_append(rec)
            return True
        except (StorageError, OSError):
            self.stats["storage_errors"] += 1
            return False

    def _drop_window(self, window: int, step: int,
                     reason: str = "backpressure",
                     error: Optional[str] = None) -> None:
        """Backpressure/storage shed: the window's queued-or-journaled
        steps are discarded and the window is terminally DROPPED."""
        self._dropped.add(window)
        self.stats["dropped_windows"] += 1
        self.stats["dropped_steps"] += step - window * self.n_steps + 1
        if self.journal:
            journal_gc(journal_dir(self.out_dir),
                       window * self.n_steps, step + 1)
        rec = {"window": window, "status": DROPPED, "reason": reason,
               "n_steps": self.n_steps}
        if error is not None:
            rec["error"] = error
        self._manifest_append_safe(rec)

    def _recover_journal(self) -> List[Tuple[int, object]]:
        """Restart path: GC terminal windows' segments, load replayable
        steps, and position ``next_step`` (shared `recover_journal_dir`
        protocol — the gateway runs the same scan per tenant)."""
        replay, self._next_step = recover_journal_dir(
            self.out_dir, self.n_steps, self._manifest,
            self._manifest_append, self.device)
        return replay

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        self._rng = np.random.default_rng(self.rng_seed)
        pending: Dict[int, Dict[int, object]] = {}
        try:
            while True:
                item = self._queue.get()
                if item is None:
                    for w in sorted(pending):
                        if w in self._dropped:
                            continue
                        k = len(pending[w])
                        self.stats["partial_steps"] += k
                        self._manifest_append_safe(
                            {"window": w, "status": PARTIAL,
                             "n_steps": k, "of": self.n_steps})
                    return
                step, wit = item
                w = step // self.n_steps
                if w in self._dropped:
                    pending.pop(w, None)
                    continue
                pending.setdefault(w, {})[step] = wit
                if len(pending[w]) < self.n_steps:
                    continue
                wits = [pending[w][s] for s in sorted(pending[w])]
                del pending[w]
                if w in self._dropped:
                    continue
                self._prove_window(w, wits)
        except Exception as exc:          # surfaced by submit()/close()
            self._errors.append(exc)

    def _proof_path(self, window: int) -> str:
        return os.path.join(self.out_dir, f"proof_{window:06d}.bin")

    def _prove_window(self, window: int, wits) -> None:
        from repro_torch.core.pipeline import ProofSession, encode_proof
        from repro_torch.train.checkpoint import atomic_write_bytes

        if self.injector is not None:
            self.injector.fire("worker/kill")
        t0 = time.perf_counter()
        path = self._proof_path(window)

        if self.isolation == "subprocess":
            res = supervise.run_subprocess_supervised(
                self._child_argv(window), max_attempts=self.max_attempts,
                backoff_base=self.backoff_base, backoff_cap=self.backoff_cap,
                timeout=self.prove_timeout, retry_nonzero=True,
                capture_output=True, text=True, env=self._child_env())
            data = None
            if res.ok:
                with open(path, "rb") as f:
                    data = f.read()     # the child wrote it atomically
            error = res.last_error
            if not res.ok and res.value is not None and res.value.stderr:
                error = f"{error}: {res.value.stderr.strip()[-400:]}"
        else:
            def attempt():
                if self.injector is not None:
                    self.injector.fire("prove/mid")
                session = ProofSession(self.pk, self._rng, label=self.label)
                for wit in wits:
                    session.add_step(wit)
                proof = session.prove()
                if self.verify and not session.verify(proof):
                    raise RuntimeError(f"window {window}: proof REJECTED")
                return encode_proof(proof)

            res = supervise.run_supervised(
                attempt, max_attempts=self.max_attempts,
                backoff_base=self.backoff_base,
                backoff_cap=self.backoff_cap)
            data = res.value if res.ok else None
            error = res.last_error

        self.stats["retries"] += max(0, res.n_attempts - 1)
        if not res.ok:
            self.stats["failed_windows"] += 1
            self._manifest_append_safe({"window": window, "status": FAILED,
                                        "error": error,
                                        "attempts": res.n_attempts})
            return
        if self.isolation != "subprocess":
            from repro_torch.train.checkpoint import StorageError
            try:
                if self.injector is not None:
                    self.injector.fire("storage/proof")
                atomic_write_bytes(path, data)
            except StorageError as exc:
                # disk full at the proof write: the window FAILS (its
                # journal is retained for a restart with free space) and
                # the worker loop keeps serving the next window
                self.stats["storage_errors"] += 1
                self.stats["failed_windows"] += 1
                self._manifest_append_safe(
                    {"window": window, "status": FAILED,
                     "reason": "storage", "error": str(exc)})
                return
        if self.injector is not None:
            self.injector.fire("commit/pre-manifest")
        dt = time.perf_counter() - t0
        batch = self.pk.keys.cfg.batch
        committed = self._manifest_append_safe(
            {"window": window, "status": COMMITTED,
             "n_steps": self.n_steps, "bytes": len(data),
             # global sample-index range [start, count]
             # of the window's per-sample commitments —
             # the membership audit (repro_torch.audit) binds
             # these into the dataset root
             "samples": [window * self.n_steps * batch,
                         self.n_steps * batch],
             "prove_s": round(dt, 4),
             "attempts": res.n_attempts})
        if not committed:
            # proof bytes are durable but the commit line is not: leave
            # the journal in place so a restart re-proves and commits —
            # NEVER GC ahead of the manifest
            return
        if self.journal:
            journal_gc(journal_dir(self.out_dir),
                       window * self.n_steps, (window + 1) * self.n_steps)
        self.stats["proved"] += 1
        self.proofs.append((window, path, len(data), dt))

    def _child_argv(self, window: int) -> List[str]:
        return _child_argv(window, self.out_dir, self.rng_seed, self.label,
                           self.verify, self.device, self.pk.cfg)

    def _child_env(self) -> Dict[str, str]:
        return _subprocess_env()


def _child_argv(window: int, out_dir: str, seed: int, label: bytes,
                verify: bool, device, cfg) -> List[str]:
    """A ``--prove-window`` child's argv: the parent's device, and the
    merged key length of the ``vk.bin`` it wrote as the child's decode
    cap (the default cap guards untrusted bytes, and a full-width key
    is above it)."""
    from repro_torch.core.pipeline.proofio import VK_MAX_MERGED_LEN

    argv = [sys.executable, "-m", "repro_torch.launch.serve",
            "--prove-window", str(window), "--out-dir", out_dir,
            "--seed", str(seed), "--label", label.decode(),
            "--device", device.type,
            "--max-merged-len", str(max(VK_MAX_MERGED_LEN, cfg.merged_len))]
    if verify:
        argv.append("--verify")
    return argv


def _subprocess_env() -> Dict[str, str]:
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _release_cached_memory(device) -> None:
    """Hand the caching allocator's free blocks back to the card (after a
    warm-up prove, before any prove child needs the memory)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Multi-tenant proving gateway
# ---------------------------------------------------------------------------

_TENANT_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


@dataclasses.dataclass
class WindowJob:
    """One full window queued for proving."""
    window: int
    wits: List[object]
    enqueued_t: float                  # time.monotonic() at admission
    deadline_t: Optional[float] = None
    trial: bool = False                # breaker half-open probe
    kills: int = 0                     # workers that died holding this job


class _Tenant:
    """Per-tenant state: its own directory (journal + manifest + vk +
    proofs — byte-compatible with a single `ProverService` out_dir, so
    `verify_bytes`, the membership audit and the recovery protocol all
    work unchanged per tenant), its own keys, breaker, window assembly
    and counters."""

    def __init__(self, gateway: "ProvingGateway", name: str, n_steps: int,
                 weight: float, priority: int, deadline_s: Optional[float],
                 label: bytes, verify: bool, rng_seed: int):
        self.gateway = gateway
        self.name = name
        self.dir = os.path.join(gateway.out_dir, TENANTS_DIR, name)
        self.n_steps = n_steps
        self.weight = weight
        self.priority = priority
        self.deadline_s = deadline_s
        self.label = label
        self.verify = verify
        self.rng_seed = rng_seed
        self.pk = None
        self.vk = None
        self.cfg = None
        self.breaker = CircuitBreaker(gateway.breaker_threshold,
                                      gateway.breaker_reset_s)
        self.lock = threading.RLock()   # pending/manifest/stats/next_step
        self.pending: Dict[int, Dict[int, object]] = {}
        self.parked: "collections.deque" = collections.deque()
        self.manifest: Dict[int, dict] = {}
        self.dropped: set = set()
        self.next_step = 0
        self.proofs: List[Tuple[int, str, int, float]] = []
        self.stats = {"submitted": 0, "journaled": 0, "replayed": 0,
                      "rejected": 0, "proved": 0, "failed_windows": 0,
                      "deadline_expired": 0, "shed_windows": 0,
                      "dropped_windows": 0, "dropped_steps": 0,
                      "partial_steps": 0, "retries": 0, "deferred": 0,
                      "storage_errors": 0}

    def proof_path(self, window: int) -> str:
        return os.path.join(self.dir, f"proof_{window:06d}.bin")

    def child_argv(self, window: int) -> List[str]:
        return _child_argv(window, self.dir, self.rng_seed, self.label,
                           self.verify, self.gateway.device, self.cfg)

    def _manifest_append(self, rec: dict) -> None:
        if self.gateway.injector is not None:
            self.gateway.injector.fire("storage/manifest")
        with self.lock:
            with open(os.path.join(self.dir, MANIFEST), "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self.manifest[int(rec["window"])] = rec

    def _manifest_append_safe(self, rec: dict) -> bool:
        from repro_torch.train.checkpoint import StorageError

        try:
            self._manifest_append(rec)
            return True
        except (StorageError, OSError):
            with self.lock:
                self.stats["storage_errors"] += 1
            return False

    def snapshot(self, queued: int) -> dict:
        with self.lock:
            return {"queued": queued, "parked": len(self.parked),
                    "pending_steps": sum(len(v)
                                         for v in self.pending.values()),
                    "next_step": self.next_step,
                    "breaker": self.breaker.state,
                    "breaker_trips": self.breaker.trips,
                    "weight": self.weight, "priority": self.priority,
                    "deadline_s": self.deadline_s,
                    "committed": self.stats["proved"],
                    "failed": self.stats["failed_windows"],
                    "dropped": self.stats["dropped_windows"],
                    "shed": self.stats["shed_windows"],
                    "rejected": self.stats["rejected"],
                    "deadline_expired": self.stats["deadline_expired"],
                    "deferred": self.stats["deferred"],
                    "retries": self.stats["retries"],
                    "replayed": self.stats["replayed"],
                    "storage_errors": self.stats["storage_errors"]}


class ProvingGateway:
    """Multi-tenant proving gateway: one warm process, N supervised
    prove workers, many isolated tenants.

    Each tenant registered with `add_tenant` gets its own directory
    under ``<out_dir>/tenants/<name>/`` with its own vk.bin, journal,
    manifest and proof files — the SAME durability contract as a
    single `ProverService` out_dir, enforced per tenant (exactly one
    COMMITTED line per non-shed window, journal GC only after a
    terminal line, manifest as the sole source of truth).  On top of
    that, the gateway adds the multi-tenant control plane:

    * preflight validation — `submit()` rejects malformed witnesses
      with typed `WitnessValidationError`\\ s BEFORE journaling;
    * weighted-fair scheduling + priority load-shedding
      (`admission.WeightedFairQueue`);
    * per-window deadlines (expired at dispatch -> ``FAILED`` with
      reason ``deadline``; the worker is reclaimed immediately);
    * a per-tenant circuit breaker (K consecutive prove failures trip
      the tenant to journal-only; a half-open trial window re-closes
      it) — tripped windows are PARKED in memory with their journal
      retained, so nothing durable is lost while degraded;
    * a worker pool with a monitor thread that respawns dead workers
      and requeues the job a dead worker held (re-commit is impossible:
      the worker re-checks the tenant manifest before proving);
    * one advisory lockfile for the whole ``out_dir``
      (`admission.acquire_dir_lock`).

    Every tenant's keys and proves live on the gateway's ``device``
    (None: the card); pool workers share it.

    Thread model: `submit()` may be called from MANY client threads
    (one per tenant or otherwise); per-tenant state is guarded by the
    tenant lock, cross-tenant dispatch by the queue's condition, and
    every worker owns a job exclusively from dequeue to terminal line.
    """

    FAULT_POINTS = ("pool/worker-kill", "gateway/pre-prove", "prove/mid",
                    "commit/pre-manifest", "storage/journal",
                    "storage/proof", "storage/manifest", "lock/acquire",
                    "breaker/trip")

    def __init__(self, out_dir: str, *, n_workers: int = 2,
                 queue_windows: int = 0, backpressure: str = "block",
                 isolation: str = "thread", max_attempts: int = 3,
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 prove_timeout: Optional[float] = None,
                 breaker_threshold: int = 3, breaker_reset_s: float = 30.0,
                 compact_threshold: int = 10000, preflight: bool = True,
                 injector=None, device=None):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if backpressure not in ("block", "drop_window"):
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        if isolation not in ("thread", "subprocess"):
            raise ValueError(f"unknown isolation mode {isolation!r}")
        self.device = resolve_device(device)
        self.out_dir = out_dir
        self.n_workers = n_workers
        self.backpressure = backpressure
        self.isolation = isolation
        self.max_attempts = max_attempts
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.prove_timeout = prove_timeout
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.compact_threshold = compact_threshold
        self.preflight = preflight
        self.injector = injector
        self.queue = WeightedFairQueue(capacity=queue_windows)
        self.tenants: Dict[str, _Tenant] = {}
        self.stats = {"worker_respawns": 0, "storage_errors": 0}
        self._workers: List[Optional[threading.Thread]] = []
        self._worker_done: List[bool] = []
        self._worker_events: List[dict] = []
        self._inflight: Dict[int, Tuple[str, WindowJob]] = {}
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._lock_path: Optional[str] = None
        self._started = False
        self._draining = False
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ProvingGateway":
        """Take the directory lock and launch the worker pool + monitor.
        Tenants are registered afterwards with `add_tenant` (their
        recovery replay starts proving immediately)."""
        if self._closed:
            raise ServiceClosedError("gateway already closed")
        if self._started:
            raise RuntimeError("gateway already started")
        os.makedirs(self.out_dir, exist_ok=True)
        self._lock_path = acquire_dir_lock(self.out_dir,
                                           injector=self.injector)
        self._workers = [None] * self.n_workers
        self._worker_done = [False] * self.n_workers
        for wid in range(self.n_workers):
            self._spawn_worker(wid)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="zkdl-gw-monitor")
        self._monitor.start()
        self._started = True
        return self

    def add_tenant(self, name: str, graph, quant=None, n_steps: int = 1, *,
                   weight: float = 1.0, priority: int = 0,
                   deadline_s: Optional[float] = None,
                   label: bytes = b"zkdl/train", verify: bool = False,
                   rng_seed: int = 0, warm: bool = False) -> _Tenant:
        """Register (or re-open after a restart) one tenant: compile its
        keys, write its vk.bin, auto-compact an oversized manifest,
        recover its journal, and admit the replayable windows.  Returns
        the tenant handle (stats / proofs / dir are public on it)."""
        from repro_torch.core.pipeline import compile as zk_compile
        from repro_torch.train.checkpoint import atomic_write_bytes

        if not self._started:
            raise RuntimeError("gateway not started")
        if self._closed or self._draining:
            raise ServiceClosedError("gateway is closing")
        if not _TENANT_NAME_RE.match(name):
            raise ValueError(
                f"invalid tenant name {name!r}: must match "
                f"{_TENANT_NAME_RE.pattern} (it becomes a directory name)")
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        t = _Tenant(self, name, n_steps, weight, priority, deadline_s,
                    label, verify, rng_seed)
        os.makedirs(t.dir, exist_ok=True)
        _clean_tmp_files(t.dir)
        if (self.compact_threshold
                and manifest_line_count(t.dir) > self.compact_threshold):
            compact_manifest(t.dir)
        t.pk, t.vk = zk_compile(graph, quant, n_steps=n_steps,
                                device=self.device)
        t.cfg = t.pk.keys.cfg
        if warm:
            t.pk.warm(seed=rng_seed)
            _release_cached_memory(self.device)
        atomic_write_bytes(os.path.join(t.dir, "vk.bin"), t.vk.to_bytes())
        t.manifest = read_manifest(t.dir)
        t.dropped = {w for w, rec in t.manifest.items()
                     if rec.get("status") in (DROPPED, SHED)}
        replay, t.next_step = recover_journal_dir(
            t.dir, n_steps, t.manifest, t._manifest_append, self.device)
        self.queue.add_tenant(name, weight=weight, priority=priority)
        self.tenants[name] = t
        # reassemble replayed steps into windows; full windows are
        # force-admitted (durable work is never shed), the trailing
        # partial window waits in pending for its remaining submits
        by_window: Dict[int, Dict[int, object]] = {}
        for s, wit in replay:
            by_window.setdefault(s // n_steps, {})[s] = wit
            t.stats["replayed"] += 1
        now = time.monotonic()
        for w in sorted(by_window):
            if len(by_window[w]) < n_steps:
                t.pending[w] = by_window[w]
                continue
            wits = [by_window[w][s] for s in sorted(by_window[w])]
            job = WindowJob(window=w, wits=wits, enqueued_t=now,
                            deadline_t=(None if deadline_s is None
                                        else now + deadline_s))
            self.queue.push(name, job, force=True)
        return t

    # -- submit path -------------------------------------------------------

    def submit(self, tenant: str, wit, step: Optional[int] = None) -> None:
        """Validate, journal and enqueue one step witness for ``tenant``.

        Order of checks (nothing is journaled unless ALL pass):
        preflight geometry/range validation (`WitnessValidationError`
        subclasses), step monotonicity (`WitnessStepError`), then the
        durable journal append under the storage policy (``block``
        retries a full disk with backoff then raises; ``drop_window``
        terminally DROPs the window).  When the step completes a window,
        the window enters the weighted-fair queue — which may shed a
        lower-priority tenant's newest window (terminal ``SHED`` line,
        journal GC'd, counted in its stats)."""
        if self._closed or self._draining:
            raise ServiceClosedError(
                "submit() after close(): the gateway accepts no new work")
        if not self._started:
            raise RuntimeError("gateway not started")
        t = self.tenants.get(tenant)
        if t is None:
            raise ValueError(f"unknown tenant {tenant!r}")
        job = None
        with t.lock:
            t.stats["submitted"] += 1
            try:
                if self.preflight:
                    validate_witness(t.cfg, wit)
                s = check_step_monotonic(tenant, t.next_step, step)
            except WitnessValidationError:
                t.stats["rejected"] += 1
                raise
            w = s // t.n_steps
            if not self._journal_tenant_step(t, w, s, wit):
                t.next_step = s + 1
                return                  # window terminally DROPPED
            t.stats["journaled"] += 1
            t.next_step = s + 1
            if w in t.dropped:
                t.stats["dropped_steps"] += 1
                journal_gc(journal_dir(t.dir), s, s + 1)
                return
            t.pending.setdefault(w, {})[s] = wit
            if len(t.pending[w]) < t.n_steps:
                return
            wits = [t.pending[w][k] for k in sorted(t.pending[w])]
            del t.pending[w]
            now = time.monotonic()
            job = WindowJob(window=w, wits=wits, enqueued_t=now,
                            deadline_t=(None if t.deadline_s is None
                                        else now + t.deadline_s))
        self._admit(t, job)

    def _journal_tenant_step(self, t: _Tenant, window: int, step: int,
                             wit) -> bool:
        from repro_torch.train.checkpoint import StorageError

        jdir = journal_dir(t.dir)

        def write():
            if self.injector is not None:
                self.injector.fire("storage/journal")
            journal_append(jdir, step, wit)

        if self.backpressure == "block":
            res = supervise.run_supervised(
                write, max_attempts=self.max_attempts,
                backoff_base=self.backoff_base,
                backoff_cap=self.backoff_cap, retry_on=(StorageError,))
            t.stats["storage_errors"] += res.n_attempts - (1 if res.ok
                                                           else 0)
            if not res.ok:
                raise res.error
            return True
        try:
            write()
            return True
        except StorageError as exc:
            t.stats["storage_errors"] += 1
            t.dropped.add(window)
            t.stats["dropped_windows"] += 1
            t.stats["dropped_steps"] += (
                len(t.pending.pop(window, {})) + 1)
            journal_gc(jdir, window * t.n_steps, step + 1)
            t._manifest_append_safe(
                {"window": window, "status": DROPPED, "reason": "storage",
                 "error": str(exc), "n_steps": t.n_steps})
            return False

    def _admit(self, t: _Tenant, job: WindowJob) -> None:
        shed = self.queue.push(t.name, job)
        for victim_name, victim_job in shed:
            self._mark_shed(self.tenants[victim_name], victim_job)

    def _mark_shed(self, t: _Tenant, job: WindowJob) -> None:
        with t.lock:
            t.dropped.add(job.window)
            t.stats["shed_windows"] += 1
        t._manifest_append_safe(
            {"window": job.window, "status": SHED, "reason": "admission",
             "n_steps": t.n_steps})
        journal_gc(journal_dir(t.dir), job.window * t.n_steps,
                   (job.window + 1) * t.n_steps)

    # -- worker pool -------------------------------------------------------

    def _spawn_worker(self, wid: int) -> None:
        th = threading.Thread(target=self._worker_entry, args=(wid,),
                              daemon=True, name=f"zkdl-gw-worker-{wid}")
        self._worker_done[wid] = False
        self._workers[wid] = th
        th.start()

    def _worker_entry(self, wid: int) -> None:
        try:
            while True:
                got = self.queue.pop(timeout=0.1)
                if got is None:
                    if self._draining:
                        self._worker_done[wid] = True
                        return
                    continue
                name, job = got
                t = self.tenants[name]
                self._inflight[wid] = (name, job)
                if self.injector is not None:
                    self.injector.fire("pool/worker-kill")
                self._process(wid, t, job)
                self._inflight.pop(wid, None)
        except BaseException as exc:    # worker death: monitor reclaims
            self._worker_events.append(
                {"worker": wid, "error": f"{type(exc).__name__}: {exc}",
                 "at": round(time.monotonic(), 3)})

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(0.05):
            for wid, th in enumerate(self._workers):
                if (th is not None and not th.is_alive()
                        and not self._worker_done[wid]):
                    self._reclaim(wid)
            for t in list(self.tenants.values()):
                self._pump_parked(t)

    def _reclaim(self, wid: int) -> None:
        """A worker died mid-job: requeue its in-flight window at the
        front of its tenant's queue (or FAIL it after repeated deaths —
        a job that reliably kills workers must not loop forever) and
        respawn the worker slot."""
        inflight = self._inflight.pop(wid, None)
        if inflight is not None:
            name, job = inflight
            t = self.tenants.get(name)
            job.kills += 1
            if t is not None:
                if job.kills >= self.max_attempts:
                    with t.lock:
                        t.stats["failed_windows"] += 1
                    t._manifest_append_safe(
                        {"window": job.window, "status": FAILED,
                         "reason": "worker-death",
                         "error": f"{job.kills} workers died holding "
                                  f"this window"})
                else:
                    self.queue.requeue(name, job)
        self.stats["worker_respawns"] += 1
        self._spawn_worker(wid)

    def _pump_parked(self, t: _Tenant) -> None:
        """Release parked (breaker-gated) windows back into the queue:
        all of them once the breaker is closed, exactly one probe when
        it is ready to half-open."""
        with t.lock:
            if not t.parked:
                return
            if t.breaker.state == "closed":
                jobs = list(t.parked)
                t.parked.clear()
            elif t.breaker.ready_for_trial:
                jobs = [t.parked.popleft()]
            else:
                return
        for job in jobs:
            job.trial = False           # re-gated at dispatch
            self.queue.requeue(t.name, job)

    # -- window processing -------------------------------------------------

    def _process(self, wid: int, t: _Tenant, job: WindowJob) -> None:
        from repro_torch.train.checkpoint import StorageError, atomic_write_bytes

        with t.lock:
            rec = t.manifest.get(job.window)
            if ((rec is not None and rec.get("status") in GC_STATES)
                    or job.window in t.dropped):
                return                  # requeued after its terminal line
        now = time.monotonic()
        if job.deadline_t is not None and now > job.deadline_t:
            with t.lock:
                t.stats["deadline_expired"] += 1
                t.stats["failed_windows"] += 1
            t._manifest_append_safe(
                {"window": job.window, "status": FAILED,
                 "reason": "deadline",
                 "waited_s": round(now - job.enqueued_t, 3)})
            if job.trial:               # an expired probe re-opens
                t.breaker.record_failure()
            return
        if not job.trial:
            verdict = t.breaker.allow()
            if verdict == "defer":
                with t.lock:
                    t.stats["deferred"] += 1
                    t.parked.append(job)
                return
            job.trial = verdict == "trial"
        t0 = time.perf_counter()
        res, data, error, timed_out = self._attempt_window(t, job, now)
        with t.lock:
            t.stats["retries"] += max(0, res.n_attempts - 1)
        if not res.ok:
            reason = "deadline" if timed_out else "prove"
            with t.lock:
                t.stats["failed_windows"] += 1
                if timed_out:
                    t.stats["deadline_expired"] += 1
            t._manifest_append_safe(
                {"window": job.window, "status": FAILED, "reason": reason,
                 "error": error, "attempts": res.n_attempts})
            if reason == "deadline" and not job.trial:
                return                  # capacity, not prover health
            tripped = t.breaker.record_failure()
            if tripped and self.injector is not None:
                self.injector.fire("breaker/trip")
            return
        path = t.proof_path(job.window)
        if self.isolation != "subprocess":
            try:
                if self.injector is not None:
                    self.injector.fire("storage/proof")
                atomic_write_bytes(path, data)
            except StorageError as exc:
                with t.lock:
                    t.stats["failed_windows"] += 1
                    t.stats["storage_errors"] += 1
                t._manifest_append_safe(
                    {"window": job.window, "status": FAILED,
                     "reason": "storage", "error": str(exc)})
                if job.trial:           # infra failure still ends the probe
                    t.breaker.record_failure()
                return
        if self.injector is not None:
            self.injector.fire("commit/pre-manifest")
        dt = time.perf_counter() - t0
        batch = t.cfg.batch
        committed = t._manifest_append_safe(
            {"window": job.window, "status": COMMITTED,
             "n_steps": t.n_steps, "bytes": len(data),
             "samples": [job.window * t.n_steps * batch,
                         t.n_steps * batch],
             "prove_s": round(dt, 4), "attempts": res.n_attempts,
             "worker": wid})
        if not committed:
            # proof durable, commit line not: journal stays, restart
            # re-proves and commits — never GC ahead of the manifest
            if job.trial:
                t.breaker.record_failure()
            return
        journal_gc(journal_dir(t.dir), job.window * t.n_steps,
                   (job.window + 1) * t.n_steps)
        with t.lock:
            t.stats["proved"] += 1
            t.proofs.append((job.window, path, len(data), dt))
        t.breaker.record_success()

    def _attempt_window(self, t: _Tenant, job: WindowJob, now: float):
        """One supervised prove of a window.  Returns ``(result, data,
        error, timed_out)``; ``timed_out`` means the failure was the
        deadline/timeout budget, not the prover."""
        from repro_torch.core.pipeline import ProofSession, encode_proof

        if self.isolation == "subprocess":
            budget = self.prove_timeout
            if job.deadline_t is not None:
                remaining = max(0.01, job.deadline_t - now)
                budget = (remaining if budget is None
                          else min(budget, remaining))
            res = supervise.run_subprocess_supervised(
                t.child_argv(job.window), max_attempts=self.max_attempts,
                backoff_base=self.backoff_base,
                backoff_cap=self.backoff_cap, timeout=budget,
                retry_nonzero=True, capture_output=True, text=True,
                env=_subprocess_env())
            data = None
            if res.ok:
                with open(t.proof_path(job.window), "rb") as f:
                    data = f.read()
            error = res.last_error
            if not res.ok and res.value is not None and res.value.stderr:
                error = f"{error}: {res.value.stderr.strip()[-400:]}"
            timed_out = ((not res.ok)
                         and any(a.timed_out for a in res.attempts))
            return res, data, error, timed_out

        def attempt():
            if self.injector is not None:
                self.injector.fire("gateway/pre-prove")
                self.injector.fire("prove/mid")
            rng = np.random.default_rng((t.rng_seed, job.window))
            session = ProofSession(t.pk, rng, label=t.label)
            for wit in job.wits:
                session.add_step(wit)
            proof = session.prove()
            if t.verify and not session.verify(proof):
                raise RuntimeError(f"window {job.window}: proof REJECTED")
            return encode_proof(proof)

        res = supervise.run_supervised(
            attempt, max_attempts=self.max_attempts,
            backoff_base=self.backoff_base, backoff_cap=self.backoff_cap)
        return (res, res.value if res.ok else None, res.last_error, False)

    # -- status + shutdown -------------------------------------------------

    def status(self) -> dict:
        """Point-in-time health snapshot (the ``--status`` CLI reads the
        same shape from disk via `dir_status` when no gateway is live)."""
        alive = sum(1 for wid, th in enumerate(self._workers)
                    if th is not None and th.is_alive()
                    and not self._worker_done[wid])
        return {
            "started": self._started, "draining": self._draining,
            "closed": self._closed,
            "workers": {"pool": self.n_workers, "alive": alive,
                        "respawns": self.stats["worker_respawns"],
                        "inflight": {wid: (name, job.window)
                                     for wid, (name, job)
                                     in dict(self._inflight).items()},
                        "events": list(self._worker_events)},
            "queue": {"depth": self.queue.depth(),
                      "capacity": self.queue.capacity},
            "storage_errors": self.stats["storage_errors"],
            "tenants": {name: t.snapshot(self.queue.depth(name))
                        for name, t in self.tenants.items()},
        }

    def close(self, timeout: Optional[float] = None) -> None:
        """Graceful drain: stop admitting, let the pool finish every
        queued window, stop the monitor, record trailing partial windows
        as PARTIAL (journal retained), release the directory lock.
        Idempotent; never hangs on a dead pool (the monitor respawns
        workers during the drain, and the join is bounded)."""
        if self._closed:
            return
        if not self._started:
            self._closed = True
            return
        self._draining = True           # submit() rejects from here on
        self.queue.drain()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for wid in range(self.n_workers):
            while True:
                th = self._workers[wid]
                if th is None or not th.is_alive() or self._worker_done[wid]:
                    break
                budget = (0.2 if deadline is None
                          else min(0.2, deadline - time.monotonic()))
                if budget <= 0:
                    raise TimeoutError(
                        f"gateway pool did not drain within {timeout}s "
                        f"({self.queue.depth()} windows still queued; "
                        f"every journaled step is retained)")
                th.join(budget)
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(5.0)
            self._monitor = None
        for t in self.tenants.values():
            with t.lock:
                for w in sorted(t.pending):
                    if w in t.dropped:
                        continue
                    k = len(t.pending[w])
                    t.stats["partial_steps"] += k
                    t._manifest_append_safe(
                        {"window": w, "status": PARTIAL,
                         "n_steps": k, "of": t.n_steps})
        self._closed = True
        if self._lock_path is not None:
            release_dir_lock(self._lock_path)
            self._lock_path = None


def dir_status(out_dir: str) -> dict:
    """Offline (from-disk) health snapshot of a gateway or service
    directory: lock ownership, per-tenant manifest/journal/proof
    counts.  Safe to run next to a LIVE gateway — it only reads."""
    from repro_torch.launch.admission import LOCKFILE, _pid_alive

    def summary(d: str) -> dict:
        man = read_manifest(d)
        by_status: Dict[str, int] = {}
        for rec in man.values():
            st = rec.get("status", "?")
            by_status[st] = by_status.get(st, 0) + 1
        proof_files = [f for f in os.listdir(d)
                       if f.startswith("proof_") and f.endswith(".bin")] \
            if os.path.isdir(d) else []
        return {"windows": len(man), "by_status": by_status,
                "commit_lines": sum(manifest_commit_counts(d).values()),
                "journal_steps": len(journal_steps(journal_dir(d))),
                "proof_files": len(proof_files)}

    out: dict = {"out_dir": out_dir, "lock": None, "tenants": {}}
    lock_path = os.path.join(out_dir, LOCKFILE)
    if os.path.exists(lock_path):
        try:
            with open(lock_path) as f:
                owner = json.load(f)
            pid = int(owner.get("pid"))
            out["lock"] = {"pid": pid, "alive": _pid_alive(pid)}
        except (OSError, TypeError, ValueError, json.JSONDecodeError):
            out["lock"] = {"pid": None, "alive": False}
    tdir = os.path.join(out_dir, TENANTS_DIR)
    if os.path.isdir(tdir):
        for name in sorted(os.listdir(tdir)):
            d = os.path.join(tdir, name)
            if os.path.isdir(d):
                out["tenants"][name] = summary(d)
    if (os.path.exists(os.path.join(out_dir, MANIFEST))
            or os.path.isdir(journal_dir(out_dir))):
        out["service"] = summary(out_dir)
    return out


# ---------------------------------------------------------------------------
# Subprocess prove worker + CLI
# ---------------------------------------------------------------------------

def _prove_window_child(args) -> int:
    """One isolated prove attempt: rebuild the ProvingKey from vk.bin
    (decoded under the ``--max-merged-len`` cap its parent passed; the
    kernel libraries load from the build cache), load the window's
    witnesses from the journal onto ``--device``, prove, atomically write
    the proof, hard-exit.  The PARENT commits the manifest line — this
    process crashing after the proof write therefore cannot
    double-commit.  On the card it prints its setup and prove seconds and
    its peak device memory."""
    from repro_torch.core.pipeline import (ProofSession, compile as zk_compile,
                                           encode_proof)
    from repro_torch.core.pipeline.proofio import decode_vk
    from repro_torch.core.quantfc import QuantConfig
    from repro_torch.train.checkpoint import atomic_write_bytes
    from repro_torch.train.resilience import FailureInjector

    t0 = time.perf_counter()
    dev = resolve_device(args.device)
    injector = FailureInjector.from_env()
    out = args.out_dir
    with open(os.path.join(out, "vk.bin"), "rb") as f:
        vk = decode_vk(f.read(), max_merged_len=args.max_merged_len)
    cfg = vk.cfg
    pk, _ = zk_compile(cfg.graph,
                       QuantConfig(q_bits=cfg.q_bits, r_bits=cfg.r_bits),
                       n_steps=cfg.n_steps, device=dev)
    w, T = args.prove_window, cfg.n_steps
    jdir = journal_dir(out)
    wits = [journal_load(jdir, s, dev) for s in range(w * T, (w + 1) * T)]
    if injector is not None:
        injector.fire("prove/mid")
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng((args.seed, w))
    session = ProofSession(pk, rng, label=args.label.encode())
    for wit in wits:
        session.add_step(wit)
    proof = session.prove()
    if args.verify and not session.verify(proof):
        print(f"[serve:child] window {w}: proof REJECTED", flush=True)
        return 1
    data = encode_proof(proof)
    atomic_write_bytes(os.path.join(out, f"proof_{w:06d}.bin"), data)
    print(f"[serve:child] window {w}: {len(data)} B proved", flush=True)
    if dev.type == "cuda":
        print("[serve:child] " + json.dumps(
            {"window": w, "setup_s": setup_s,
             "prove_s": time.perf_counter() - t0 - setup_s,
             "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}),
            flush=True)
    # skip interpreter and CUDA teardown — the proof is already durable,
    # and the parent reads only files + returncode
    supervise.hard_exit(0)
    return 0                              # unreachable


def _gateway_main(args) -> int:
    """Synthetic multi-tenant run: one gateway, --pool workers, one
    synthetic SGD trajectory per tenant (tenant i seeds with seed+i),
    submissions interleaved round-robin.  Rerunning on the same out_dir
    after a crash resumes each tenant from its recovered next_step —
    the CLI form of the multi-tenant chaos smoke."""
    from repro_torch.core.quantfc import (QuantConfig,
                                          synthetic_sgd_trajectory_widths)
    from repro_torch.core.pipeline import build_fcnn_graph
    from repro_torch.train.resilience import FailureInjector

    specs = []
    for part in args.tenants.split(","):
        bits = part.strip().split(":")
        if not bits[0]:
            continue
        specs.append((bits[0],
                      float(bits[1]) if len(bits) > 1 else 1.0,
                      int(bits[2]) if len(bits) > 2 else 0))
    if not specs:
        print("[gateway] --tenants parsed to nothing", file=sys.stderr)
        return 2
    injector = (FailureInjector.from_spec(args.inject) if args.inject
                else FailureInjector.from_env())
    widths = tuple(int(w) for w in args.widths.split(","))
    quant = QuantConfig(q_bits=args.q_bits, r_bits=args.r_bits)
    graph = build_fcnn_graph(widths, batch=args.batch)
    gw = ProvingGateway(args.out_dir, n_workers=args.pool,
                        queue_windows=args.queue_windows,
                        backpressure=args.backpressure,
                        isolation=args.isolation,
                        max_attempts=args.max_attempts,
                        prove_timeout=args.prove_timeout,
                        breaker_threshold=args.breaker_threshold,
                        breaker_reset_s=args.breaker_reset,
                        injector=injector, device=args.device)
    gw.start()
    t0 = time.perf_counter()
    tenants = {}
    for i, (name, weight, priority) in enumerate(specs):
        tenants[name] = gw.add_tenant(
            name, graph, quant, n_steps=args.window, weight=weight,
            priority=priority, deadline_s=args.deadline,
            label=args.label.encode(), verify=args.verify,
            rng_seed=args.seed + i, warm=(i == 0))
        print(f"[gateway] tenant {name}: weight={weight} "
              f"priority={priority} resume at step "
              f"{tenants[name].next_step} "
              f"({tenants[name].stats['replayed']} steps replayed)",
              flush=True)
    if args.warm_only:
        gw.close()
        return 0
    trajs = {name: synthetic_sgd_trajectory_widths(
                 args.steps, widths, args.batch, quant,
                 seed=args.seed + i, device=gw.device)
             for i, (name, _w, _p) in enumerate(specs)}
    cursors = {name: min(tenants[name].next_step, args.steps)
               for name in trajs}
    progressed = True
    while progressed:
        progressed = False
        for name in trajs:              # round-robin interleave
            c = cursors[name]
            if c >= args.steps:
                continue
            gw.submit(name, trajs[name][c])
            cursors[name] = c + 1
            progressed = True
    gw.close()
    dt = time.perf_counter() - t0
    total = 0
    for name, t in tenants.items():
        total += t.stats["proved"]
        print(f"[gateway] tenant {name}: {t.stats['proved']} proofs, "
              f"stats={t.stats}", flush=True)
    print(f"[gateway] {total} proofs across {len(tenants)} tenants in "
          f"{dt:.1f}s; status={json.dumps(gw.status()['workers'])}",
          flush=True)
    return 0


def main(argv=None) -> int:
    from repro_torch.core.pipeline.proofio import VK_MAX_MERGED_LEN

    ap = argparse.ArgumentParser(
        description="Crash-safe warm zkDL prover service (synthetic trajectory)")
    ap.add_argument("--widths", default="4,4,4",
                    help="layer-width table d_0..d_L")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--window", type=int, default=2,
                    help="T: steps aggregated per proof")
    ap.add_argument("--steps", type=int, default=4,
                    help="synthetic training steps to drive through")
    ap.add_argument("--q-bits", type=int, default=16)
    ap.add_argument("--r-bits", type=int, default=4)
    ap.add_argument("--out-dir", default="proofs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="zkdl/train")
    ap.add_argument("--verify", action="store_true",
                    help="verify each proof before writing it")
    ap.add_argument("--warm-only", action="store_true",
                    help="compile keys + warm every kernel, then exit")
    ap.add_argument("--queue-size", type=int, default=0,
                    help="bound the submit queue (0 = unbounded)")
    ap.add_argument("--backpressure", default="block",
                    choices=["block", "drop_window"])
    ap.add_argument("--max-attempts", type=int, default=3)
    ap.add_argument("--prove-timeout", type=float, default=None)
    ap.add_argument("--isolation", default="thread",
                    choices=["thread", "subprocess"])
    ap.add_argument("--inject", default=None,
                    help="fault spec point@HITS[:action],... "
                         "(ZKDL_FAULTS env works too)")
    ap.add_argument("--bind-dataset", action="store_true",
                    help="after the run, bind every COMMITTED window's "
                         "sample commitments into dataset.bin "
                         "(repro_torch.audit membership root)")
    ap.add_argument("--status", action="store_true",
                    help="print the from-disk health snapshot of "
                         "--out-dir (lock owner, per-tenant manifest/"
                         "journal/proof counts) and exit")
    ap.add_argument("--tenants", default=None,
                    help="run the multi-tenant gateway instead of the "
                         "single service: NAME[:WEIGHT[:PRIORITY]],... "
                         "(e.g. 'alice:2,bob:1:1')")
    ap.add_argument("--pool", type=int, default=2,
                    help="gateway worker pool size")
    ap.add_argument("--queue-windows", type=int, default=0,
                    help="gateway admission-queue capacity in windows "
                         "(0 = unbounded)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-window deadline in seconds (gateway)")
    ap.add_argument("--breaker-threshold", type=int, default=3)
    ap.add_argument("--breaker-reset", type=float, default=30.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                         "plain versions of the kernels)")
    ap.add_argument("--max-merged-len", type=int, default=VK_MAX_MERGED_LEN,
                    help="prove child: the largest merged key its vk.bin "
                         "may ask to derive (the parent passes the length "
                         "of the key it wrote)")
    ap.add_argument("--prove-window", type=int, default=None,
                    help=argparse.SUPPRESS)   # internal: subprocess worker
    args = ap.parse_args(argv)

    if args.status:
        print(json.dumps(dir_status(args.out_dir), indent=1, sort_keys=True))
        return 0
    if args.prove_window is not None:
        return _prove_window_child(args)
    if args.tenants is not None:
        return _gateway_main(args)

    from repro_torch.core.quantfc import (QuantConfig,
                                          synthetic_sgd_trajectory_widths)
    from repro_torch.core.pipeline import build_fcnn_graph
    from repro_torch.train.resilience import FailureInjector

    injector = (FailureInjector.from_spec(args.inject) if args.inject
                else FailureInjector.from_env())
    widths = tuple(int(w) for w in args.widths.split(","))
    quant = QuantConfig(q_bits=args.q_bits, r_bits=args.r_bits)
    graph = build_fcnn_graph(widths, batch=args.batch)
    service = ProverService(graph, quant, n_steps=args.window,
                            out_dir=args.out_dir, verify=args.verify,
                            rng_seed=args.seed,
                            label=args.label.encode(),
                            queue_size=args.queue_size,
                            backpressure=args.backpressure,
                            max_attempts=args.max_attempts,
                            prove_timeout=args.prove_timeout,
                            isolation=args.isolation, injector=injector,
                            device=args.device)
    service.start(warm=True)
    print(f"[serve] warm in {service.warm_seconds:.1f}s "
          f"(kernel build cache: {service.warm_stats})", flush=True)
    if args.warm_only:
        service.close()
        return 0

    wits = synthetic_sgd_trajectory_widths(
        args.steps, widths, args.batch, quant, seed=args.seed,
        device=service.device)
    start_at = min(service.next_step, len(wits))
    if start_at or service.stats["replayed"]:
        print(f"[serve] resuming at step {start_at} "
              f"({service.stats['replayed']} journaled steps replayed)",
              flush=True)
    t0 = time.perf_counter()
    for wit in wits[start_at:]:
        service.submit(wit)
    service.close()
    dt = time.perf_counter() - t0
    for window, path, n_bytes, secs in service.proofs:
        print(f"[serve] window {window}: {n_bytes} B -> {path} "
              f"({secs:.2f}s)", flush=True)
    print(f"[serve] {service.n_proofs} proofs for {args.steps} steps "
          f"in {dt:.1f}s total; stats={service.stats}", flush=True)
    if args.bind_dataset:
        from repro_torch.audit.membership import bind_service_dir
        _, binding = bind_service_dir(args.out_dir)
        print(f"[serve] dataset root {binding.root.hex()} "
              f"({binding.n_samples} samples across "
              f"{len(binding.windows)} windows) -> "
              f"{os.path.join(args.out_dir, 'dataset.bin')}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
