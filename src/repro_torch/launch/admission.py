"""Admission control for the multi-tenant proving gateway.

Three small, independently-testable primitives `launch/serve.py`'s
`ProvingGateway` composes (a copy of the reference's
`repro.launch.admission`; none of them import torch or any prover
module — like `launch/supervise`, the control plane must stay correct
even when the proving data plane is what's failing):

`WeightedFairQueue`
    A priority-aware, weighted-fair admission queue over named tenants.
    Dispatch order is stride scheduling: each tenant carries a virtual
    time that advances by ``1/weight`` per dispatched item, and the
    backlogged tenant with the smallest virtual time goes next — a
    tenant with weight 2 drains twice as fast as one with weight 1, and
    a flooding tenant cannot starve the rest (its virtual time runs
    ahead, so everyone else's queued work schedules first).  A tenant
    idle-then-busy re-enters at the global virtual time, not at zero —
    idleness banks no credit.

    With a ``capacity`` bound, `push` load-sheds by PRIORITY when the
    queue is full: the newest queued item of the lowest-priority
    backlogged tenant is shed to admit a higher-priority push; a push
    that is itself lowest-priority (or ties the minimum) sheds itself.
    Shed items are RETURNED to the caller, never silently dropped — the
    gateway turns them into terminal ``SHED`` manifest records.

`CircuitBreaker`
    Per-tenant trip-out: ``threshold`` consecutive prove failures open
    the breaker (the tenant degrades to journal-only — witnesses stay
    durable, proving stops burning pool capacity on a poisoned config);
    after ``reset_s`` it half-opens and admits ONE trial window.  Trial
    success closes the breaker, trial failure re-opens it for another
    ``reset_s``.  `allow()` returns one of ``"proceed" | "trial" |
    "defer"`` so the worker loop stays a flat three-way branch.

`acquire_dir_lock` / `release_dir_lock`
    An advisory owner lockfile for a service output directory.  Two
    gateways (or crash-safe services) sharing one ``out_dir`` would
    interleave journal GC, manifest appends and proof writes — each
    internally atomic, jointly corrupting (double commits, GC of the
    other's live segments).  The lock is an ``O_EXCL``-created JSON file
    recording the owner pid; a second acquire raises `GatewayBusyError`
    while the owner lives, and STEALS the lock when the recorded pid is
    dead (a SIGKILLed gateway must not brick its directory).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple


class GatewayBusyError(RuntimeError):
    """Another live gateway owns this output directory's lockfile."""


class ServiceClosedError(RuntimeError):
    """submit() after close(): the service accepts no new work."""


# ---------------------------------------------------------------------------
# Weighted-fair admission queue
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _TenantQueue:
    weight: float
    priority: int
    q: Deque = dataclasses.field(default_factory=collections.deque)
    vtime: float = 0.0


class WeightedFairQueue:
    """Thread-safe weighted-fair queue with priority load-shedding.

    ``capacity`` bounds the TOTAL queued items across tenants (0 =
    unbounded).  `push` returns the list of ``(tenant, item)`` pairs
    shed to admit the push — possibly including the pushed item itself.
    `pop` blocks up to ``timeout`` and returns ``(tenant, item)`` or
    None (timeout, or draining with nothing left).  `drain()` wakes all
    waiters; after it, `pop` returns None once the queue is empty
    instead of blocking forever."""

    def __init__(self, capacity: int = 0):
        self.capacity = capacity
        self._cond = threading.Condition()
        self._tenants: Dict[str, _TenantQueue] = {}
        self._gvt = 0.0               # global virtual time (last dispatch)
        self._draining = False

    def add_tenant(self, name: str, weight: float = 1.0,
                   priority: int = 0) -> None:
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        with self._cond:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = _TenantQueue(weight=float(weight),
                                               priority=int(priority))

    # -- introspection ----------------------------------------------------
    def depth(self, name: Optional[str] = None) -> int:
        with self._cond:
            if name is not None:
                return len(self._tenants[name].q)
            return sum(len(t.q) for t in self._tenants.values())

    def empty(self) -> bool:
        return self.depth() == 0

    # -- producer side ----------------------------------------------------
    def push(self, name: str, item,
             force: bool = False) -> List[Tuple[str, object]]:
        """``force=True`` bypasses the capacity bound (recovery replay:
        already-durable windows are admitted, never shed)."""
        with self._cond:
            if self._draining:
                raise ServiceClosedError(
                    "admission queue is draining; no new work accepted")
            t = self._tenants[name]
            shed: List[Tuple[str, object]] = []
            total = sum(len(q.q) for q in self._tenants.values())
            if self.capacity and not force and total >= self.capacity:
                # lowest-priority backlogged tenant gives up its newest
                # item; ties (or a push that IS the minimum) shed the
                # push itself — equals never preempt equals
                backlogged = [(n, q) for n, q in self._tenants.items()
                              if q.q]
                victim_name, victim = min(
                    backlogged, key=lambda nq: (nq[1].priority, nq[0]))
                if victim.priority < t.priority:
                    shed.append((victim_name, victim.q.pop()))
                else:
                    shed.append((name, item))
                    return shed
            if not t.q:               # idle -> busy: no banked credit
                t.vtime = max(t.vtime, self._gvt)
            t.q.append(item)
            self._cond.notify()
            return shed

    # -- consumer side ----------------------------------------------------
    def pop(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[str, object]]:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while True:
                backlogged = [(n, t) for n, t in self._tenants.items()
                              if t.q]
                if backlogged:
                    name, t = min(backlogged,
                                  key=lambda nt: (nt[1].vtime, nt[0]))
                    item = t.q.popleft()
                    self._gvt = t.vtime
                    t.vtime += 1.0 / t.weight
                    return name, item
                if self._draining:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)

    def requeue(self, name: str, item) -> None:
        """Put an in-flight item back at the FRONT of its tenant's queue
        (a reclaimed worker's job must not lose its turn)."""
        with self._cond:
            self._tenants[name].q.appendleft(item)
            self._cond.notify()

    def drain(self) -> None:
        with self._cond:
            self._draining = True
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Consecutive-failure trip-out with timed half-open recovery."""

    def __init__(self, threshold: int = 3, reset_s: float = 30.0,
                 clock=time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._trial_inflight = False
        self.trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            if (self._state == OPEN and not self._trial_inflight
                    and self._clock() >= self._open_until):
                return HALF_OPEN        # would half-open on next allow()
            return self._state

    @property
    def ready_for_trial(self) -> bool:
        """True exactly when the next `allow()` would return ``"trial"``
        — the unpark pump uses this to release ONE probe window without
        flooding the queue while a trial is already in flight."""
        with self._lock:
            return (self._state != CLOSED and not self._trial_inflight
                    and self._clock() >= self._open_until)

    def allow(self) -> str:
        """``"proceed"`` (closed), ``"trial"`` (half-open: caller runs
        ONE probe and MUST report its outcome), or ``"defer"`` (open, or
        a trial is already in flight)."""
        with self._lock:
            if self._state == CLOSED:
                return "proceed"
            if self._trial_inflight:
                return "defer"
            if self._clock() >= self._open_until:
                self._state = HALF_OPEN
                self._trial_inflight = True
                return "trial"
            return "defer"

    def record_success(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._trial_inflight = False

    def record_failure(self) -> bool:
        """Returns True when THIS failure tripped the breaker open."""
        with self._lock:
            self._failures += 1
            tripped = False
            if self._state == HALF_OPEN or self._failures >= self.threshold:
                tripped = self._state != OPEN
                self._state = OPEN
                self._open_until = self._clock() + self.reset_s
                if tripped:
                    self.trips += 1
            self._trial_inflight = False
            return tripped


# ---------------------------------------------------------------------------
# Advisory directory lock
# ---------------------------------------------------------------------------

LOCKFILE = "GATEWAY.lock"

# directories locked by THIS process (two gateways in one process would
# corrupt a directory exactly like two processes — the pid in the
# lockfile cannot tell them apart, so acquire also checks here)
_held_dirs: set = set()
_held_mutex = threading.Lock()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def acquire_dir_lock(out_dir: str, injector=None) -> str:
    """Take the advisory owner lock on ``out_dir``.  Raises
    `GatewayBusyError` while another LIVE process holds it; a lock whose
    recorded pid is dead is stale (SIGKILLed owner) and is stolen.
    Returns the lock path for `release_dir_lock`."""
    os.makedirs(out_dir, exist_ok=True)
    if injector is not None:
        injector.fire("lock/acquire")
    path = os.path.join(out_dir, LOCKFILE)
    real = os.path.realpath(out_dir)
    with _held_mutex:
        if real in _held_dirs:
            raise GatewayBusyError(
                f"{out_dir!r} is already owned by a live gateway in THIS "
                f"process (lockfile {path})")
    for _ in range(3):                # steal-then-race needs one retry
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                with open(path) as f:
                    owner = json.load(f)
            except (OSError, json.JSONDecodeError):
                owner = {}
            pid = owner.get("pid")
            if pid is not None and int(pid) != os.getpid() \
                    and _pid_alive(int(pid)):
                raise GatewayBusyError(
                    f"{out_dir!r} is owned by live gateway pid {pid} "
                    f"(lockfile {path}); refusing to run two gateways "
                    f"against one output directory")
            # stale (dead or unreadable owner) or our own leftover: steal
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            continue
        with os.fdopen(fd, "w") as f:
            json.dump({"pid": os.getpid(), "t": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        with _held_mutex:
            _held_dirs.add(real)
        return path
    raise GatewayBusyError(
        f"could not acquire {path}: lost the steal race repeatedly")


def release_dir_lock(path: str) -> None:
    """Release an advisory lock THIS process owns (no-op otherwise)."""
    with _held_mutex:
        _held_dirs.discard(os.path.realpath(os.path.dirname(path)))
    try:
        with open(path) as f:
            owner = json.load(f)
    except (OSError, json.JSONDecodeError):
        return
    if owner.get("pid") == os.getpid():
        try:
            os.remove(path)
        except FileNotFoundError:
            pass
