"""Supervised execution: retry/backoff for functions and subprocesses.

A copy of the reference's framework-free supervisor
(`repro.launch.supervise`), kept in the port so that nothing here
imports the reference.  Two patterns:

* run risky native work in its own subprocess, flush the success
  marker, and ``os._exit`` past interpreter teardown (a native runtime
  that crashes at teardown must not turn a durable result into a
  failure);
* retry subprocesses that die on a SIGNAL (negative returncode) while
  never retrying clean failures.

Both come with capped exponential backoff and a structured attempt
log, so the crash-safe `launch.serve.ProverService` and the tests share
one supervisor:

    res = run_supervised(prove_once, max_attempts=3)
    if not res.ok:
        mark_failed(res.attempts[-1].error)

    res = run_subprocess_supervised(argv, timeout=120.0,
                                    retry_nonzero=True, ...)
    # signal deaths and timeouts retry; res.value is the final
    # CompletedProcess either way

Nothing here imports torch: the supervisor must stay importable (and
correct) even when the supervised work is what crashes the runtime.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from typing import Any, Callable, List, Optional, Sequence


@dataclasses.dataclass
class Attempt:
    """One supervised try: what happened and how long it took."""
    index: int
    seconds: float
    error: Optional[str] = None     # None = success
    signal: Optional[int] = None    # set when a subprocess died on a signal
    timed_out: bool = False


@dataclasses.dataclass
class SuperviseResult:
    """Outcome of a supervised run.  ``value`` is the wrapped function's
    return value (in-process) or the final `CompletedProcess`
    (subprocess); ``error`` keeps the last exception object so callers
    can re-raise with full context."""
    ok: bool
    value: Any = None
    attempts: List[Attempt] = dataclasses.field(default_factory=list)
    error: Optional[BaseException] = None

    @property
    def n_attempts(self) -> int:
        return len(self.attempts)

    @property
    def last_error(self) -> Optional[str]:
        for att in reversed(self.attempts):
            if att.error is not None:
                return att.error
        return None


def backoff_delays(n: int, base: float = 0.05, cap: float = 2.0
                   ) -> List[float]:
    """Capped exponential backoff schedule: base * 2^i, clipped to cap."""
    return [min(cap, base * (2.0 ** i)) for i in range(max(0, n))]


def run_supervised(fn: Callable[[], Any], *, max_attempts: int = 3,
                   backoff_base: float = 0.05, backoff_cap: float = 2.0,
                   retry_on=(Exception,),
                   on_retry: Optional[Callable[[int, BaseException], None]]
                   = None,
                   sleep: Callable[[float], None] = time.sleep
                   ) -> SuperviseResult:
    """Call ``fn()`` up to ``max_attempts`` times with capped exponential
    backoff between failures.

    Only exceptions matching ``retry_on`` are caught (so
    KeyboardInterrupt / SystemExit always propagate); the last exception
    rides out in ``result.error``.  ``on_retry(attempt_index, exc)``
    fires after each failed attempt that will be retried."""
    if max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    result = SuperviseResult(ok=False)
    delays = backoff_delays(max_attempts, backoff_base, backoff_cap)
    for i in range(max_attempts):
        t0 = time.perf_counter()
        try:
            value = fn()
        except retry_on as exc:
            result.attempts.append(Attempt(
                index=i, seconds=time.perf_counter() - t0,
                error=f"{type(exc).__name__}: {exc}"))
            result.error = exc
            if i + 1 < max_attempts:
                if on_retry is not None:
                    on_retry(i, exc)
                sleep(delays[i])
            continue
        result.attempts.append(Attempt(index=i,
                                       seconds=time.perf_counter() - t0))
        result.ok, result.value, result.error = True, value, None
        return result
    return result


def run_subprocess_supervised(
        argv: Sequence[str], *, max_attempts: int = 3,
        backoff_base: float = 0.5, backoff_cap: float = 10.0,
        timeout: Optional[float] = None, retry_nonzero: bool = False,
        retry_timeouts: bool = True,
        attempt_setup: Optional[Callable[[int], Sequence[str]]] = None,
        on_retry: Optional[Callable[[int, Attempt], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
        **popen_kwargs) -> SuperviseResult:
    """Run ``argv`` as a subprocess under retry supervision.

    Retry policy:

    * NEGATIVE returncodes (signal deaths: SIGKILL, SIGABRT, native
      crashes) always retry — that is the failure mode supervision
      exists for;
    * timeouts (``timeout`` seconds; the child is killed) retry when
      ``retry_timeouts`` (else the `TimeoutExpired` propagates);
    * clean nonzero exits retry only with ``retry_nonzero=True`` —
      a deliberate failure (a failed assertion, a rejected proof) must
      surface on the first attempt by default.

    ``attempt_setup(attempt_index)``, if given, runs before each try and
    returns extra argv entries (e.g. fresh scratch paths).  ``value`` is
    the final `CompletedProcess` (None only if every attempt timed out).
    """
    if max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    if timeout is not None and timeout <= 0:
        raise ValueError(
            f"timeout must be positive (got {timeout!r}); pass None for "
            f"no timeout — a zero/negative timeout would kill every "
            f"attempt before it starts")
    result = SuperviseResult(ok=False)
    delays = backoff_delays(max_attempts, backoff_base, backoff_cap)
    for i in range(max_attempts):
        extra = list(attempt_setup(i)) if attempt_setup is not None else []
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(list(argv) + extra, timeout=timeout,
                                  **popen_kwargs)
        except subprocess.TimeoutExpired as exc:
            att = Attempt(index=i, seconds=time.perf_counter() - t0,
                          error=f"timeout after {timeout}s", timed_out=True)
            result.attempts.append(att)
            result.error = exc
            if not retry_timeouts:
                raise
            if i + 1 < max_attempts:
                if on_retry is not None:
                    on_retry(i, att)
                sleep(delays[i])
            continue
        result.value = proc
        rc = proc.returncode
        if rc == 0:
            result.attempts.append(Attempt(index=i,
                                           seconds=time.perf_counter() - t0))
            result.ok, result.error = True, None
            return result
        att = Attempt(index=i, seconds=time.perf_counter() - t0,
                      error=(f"signal {-rc}" if rc < 0 else f"exit {rc}"),
                      signal=(-rc if rc < 0 else None))
        result.attempts.append(att)
        if rc > 0 and not retry_nonzero:
            return result           # clean failure: never retried
        if i + 1 < max_attempts:
            if on_retry is not None:
                on_retry(i, att)
            sleep(delays[i])
    return result


def hard_exit(status: int = 0) -> None:
    """Flush stdio and ``os._exit``: skip
    interpreter/runtime teardown after the work (and its success
    markers) are already durable.  Use at the end of subprocess workers
    whose native runtime is known to corrupt the heap AT teardown — a
    crash after the atomic result write must not be read as failure."""
    import os
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(status)
