"""Fault tolerance for long-running jobs, host-side only.

The reference's mechanisms (`repro.train.resilience`), on the port's
tensors:

* ``CheckpointPolicy`` -- periodic save + restart-from-latest.  Restore
  places every leaf on an explicit device, or re-places it under the
  current mesh by the given shardings: checkpoints store full host
  arrays, so a job can come back anywhere, on any mesh (elastic
  rescale).

* ``StragglerMonitor`` -- per-step wall-time EMA; a step slower than
  ``threshold`` x EMA flags a straggler event and triggers the caller's
  callback.

* ``FailureInjector`` -- deterministic fault simulation for tests and
  drills.  Two interfaces: the step trigger (``fail_at_step=k`` +
  ``check(step)``, used by a training loop) and NAMED FAULT POINTS
  (``faults={"point": "HITS[:action]"}`` + ``fire(point)``), used by the
  crash-safe prover service and the multi-tenant proving gateway
  (`launch/serve.py`) to inject crashes at exact pipeline locations:
  before/after the journal append, mid-prove, between the proof write
  and the manifest commit, a hard worker kill, ``pool/worker-kill``
  (top of each gateway pool worker's job loop), ``storage/journal`` /
  ``storage/proof`` / ``storage/manifest`` (immediately before the
  corresponding durable write — pair with the ``enospc`` action for
  full-disk chaos), ``lock/acquire`` (directory lock acquisition),
  ``gateway/pre-prove`` (before each pool prove attempt: a range spec
  here trips a tenant's circuit breaker) and ``breaker/trip`` (the
  instant a breaker opens).

  ``HITS`` selects WHICH hits of the point act: ``N`` (the N-th, 0-based),
  ``N-M`` (every hit in the inclusive range) or ``*`` (every hit).
  Actions: ``raise`` (default, a `SimulatedFailure`), ``kill`` (SIGKILL
  the whole process — a real signal death), ``corrupt-cache`` (truncate
  one library in the kernel build cache, then continue), ``enospc``
  (raise a typed `train/checkpoint.StorageError` with errno ENOSPC — the
  injected full-disk).  ``from_env()`` reads ``ZKDL_FAULTS`` so
  subprocess workers inherit faults, and ``ZKDL_FAULTS_ONCE=<dir>``
  makes each fault fire at most once ACROSS processes (markers on
  disk) — without it a retried subprocess would re-fire the same fault
  forever.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.train import checkpoint


@dataclasses.dataclass
class CheckpointPolicy:
    ckpt_dir: str
    every: int = 50
    keep: int = 3

    def maybe_save(self, step: int, state) -> Optional[str]:
        if step % self.every == 0 and step > 0:
            return checkpoint.save(self.ckpt_dir, step, state)
        return None

    def restore_latest(self, state_template, shardings=None, device=None):
        """Returns (state, start_step). state_template supplies the tree
        structure; ``shardings`` (optional) re-places leaves for the
        current mesh -- this is the elastic-rescale path; ``device``
        (optional) is where leaves are loaded."""
        step = checkpoint.latest_step(self.ckpt_dir)
        if step is None:
            return None, 0
        state = checkpoint.restore(self.ckpt_dir, step, state_template,
                                   shardings=shardings, device=device)
        return state, step + 1


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    ema_decay: float = 0.9
    warmup: int = 3
    _ema: float = 0.0
    _n: int = 0
    events: List[Dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float,
                on_straggler: Optional[Callable[[int, float], None]] = None
                ) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ema = dt if self._ema == 0 else (
                self.ema_decay * self._ema + (1 - self.ema_decay) * dt)
            return False
        is_straggler = dt > self.threshold * self._ema
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ema": self._ema})
            if on_straggler:
                on_straggler(step, dt)
        else:
            self._ema = self.ema_decay * self._ema + (1 - self.ema_decay) * dt
        return is_straggler


class SimulatedFailure(RuntimeError):
    pass


def _hit_matches(hits: str, hit: int) -> bool:
    """Does hit number ``hit`` (0-based) fall inside the ``HITS`` spec?
    ``N`` = exactly the N-th, ``N-M`` = the inclusive range, ``*`` =
    every hit."""
    if hits == "*":
        return True
    lo, sep, hi = hits.partition("-")
    if sep:
        return int(lo) <= hit <= int(hi)
    return hit == int(hits)


@dataclasses.dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None
    fired: bool = False
    # named fault points: {"point": "HITS" | "HITS:raise" | "HITS:kill" |
    # "HITS:corrupt-cache" | "HITS:enospc"} with HITS one of N / N-M / *
    # (0-based hit numbers of fire(point))
    faults: Dict[str, str] = dataclasses.field(default_factory=dict)
    once_dir: Optional[str] = None      # cross-process fire-once markers
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    events: List[str] = dataclasses.field(default_factory=list)

    def check(self, step: int) -> None:
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.fired):
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")

    def fire(self, point: str) -> None:
        """Hit the named fault point; acts only when a matching spec is
        armed and this hit falls in its HITS selector (and, with
        ``once_dir``, the fault has not already fired in ANY process —
        range/``*`` specs keep one marker per HIT, so each selected hit
        fires at most once across processes)."""
        hit = self.counts.get(point, 0)
        self.counts[point] = hit + 1
        spec = self.faults.get(point)
        if spec is None:
            return
        hits_str, _, action = str(spec).partition(":")
        if not _hit_matches(hits_str, hit):
            return
        action = action or "raise"
        if self.once_dir is not None:
            marker = os.path.join(
                self.once_dir,
                f"fired_{point.replace('/', '_')}_{hit}")
            if os.path.exists(marker):
                return
            os.makedirs(self.once_dir, exist_ok=True)
            with open(marker, "w") as f:
                f.write(action)
        self.events.append(f"{point}#{hit}:{action}")
        if action == "kill":
            sys.stdout.flush()
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        if action == "corrupt-cache":
            corrupt_exec_cache_entry()
            return
        if action == "enospc":
            import errno
            raise checkpoint.StorageError(
                errno.ENOSPC, f"injected ENOSPC at {point} (hit {hit})")
        raise SimulatedFailure(f"injected fault at {point} (hit {hit})")

    @classmethod
    def from_spec(cls, spec: str,
                  once_dir: Optional[str] = None) -> "FailureInjector":
        """Parse ``"point@HITS[:action][,point2@HITS[:action]]..."`` with
        ``HITS`` one of ``N`` / ``N-M`` / ``*``; a bare ``point`` means
        ``point@0`` (fire on the first hit)."""
        faults: Dict[str, str] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            point, _, rest = part.partition("@")
            faults[point] = rest or "0"
        return cls(faults=faults, once_dir=once_dir)

    @classmethod
    def from_env(cls, var: str = "ZKDL_FAULTS"
                 ) -> Optional["FailureInjector"]:
        spec = os.environ.get(var, "")
        if not spec:
            return None
        return cls.from_spec(spec,
                             once_dir=os.environ.get(var + "_ONCE") or None)


def corrupt_exec_cache_entry() -> Optional[str]:
    """Truncate one built kernel library in the build cache (the oldest
    entry by name) to half its size — the ``corrupt-cache`` fault action.
    Returns the corrupted path, or None when the cache is empty.  The
    truncated copy replaces the file by rename, so a process that has
    the library mapped keeps its pages.  The cache contract is that such
    an entry is counted (``disk_corrupt``), deleted and rebuilt by the
    next process that loads it, never a crash."""
    from repro_torch.core import execache
    d = execache.cache_dir()
    if d is None or not os.path.isdir(d):
        return None
    entries = sorted(f for f in os.listdir(d) if f.endswith(".so"))
    if not entries:
        return None
    path = os.path.join(d, entries[0])
    with open(path, "rb") as f:
        data = f.read()
    tmp = f"{path}.corrupt.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data[:max(1, len(data) // 2)])
    os.replace(tmp, path)
    return path


def run_resilient(train_loop: Callable[[Any, int], Any],
                  state_template, policy: CheckpointPolicy,
                  shardings=None, max_restarts: int = 3, device=None):
    """Drive ``train_loop(state, start_step) -> state`` with
    restart-from-latest-checkpoint on failure.  Returns final state."""
    restarts = 0
    while True:
        state, start = policy.restore_latest(state_template, shardings,
                                             device)
        try:
            return train_loop(state, start)
        except SimulatedFailure as exc:
            restarts += 1
            print(f"[resilience] {exc}; restarting from latest checkpoint "
                  f"(restart {restarts}/{max_restarts})", flush=True)
            if restarts > max_restarts:
                raise
