"""Test configuration: persistent XLA cache (NO forced device count here --
smoke tests and benches must see exactly 1 device; only launch/dryrun.py
sets xla_force_host_platform_device_count), plus the quarantine marker +
centralized retry policy for tests whose SUBPROCESSES die on known
native (XLA-CPU) signals."""
import pytest

from repro.launch.supervise import run_subprocess_supervised
from repro.util import enable_compilation_cache

enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "flaky_subprocess(retries=3): quarantines a test that drives a "
        "subprocess with a known native-crash flake (e.g. the XLA-CPU "
        "forced-host-device SIGABRT / glibc heap corruption during "
        "cross-mesh restore).  The test must launch its subprocess via "
        "the run_flaky_subprocess fixture, which retries SIGNAL deaths "
        "(negative returncode) only — real test failures (a clean exit "
        "with a failed assertion) are never retried.  Deselect the whole "
        "quarantine with `-m 'not flaky_subprocess'`.")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; the test skips itself without one "
        "(run the marked tests on the card with `-m gpu`).")
    config.addinivalue_line(
        "markers",
        "slow: a reference test that spends over a minute in XLA CPU "
        "compiles; listed in `SLOW` in the repo-root conftest.py, skipped "
        "unless selected with `-m slow`.")


@pytest.fixture
def run_flaky_subprocess(request):
    """Centralized retry-on-signal-death subprocess runner.

    Usage: mark the test ``@pytest.mark.flaky_subprocess`` (optionally
    ``retries=N``) and call ``run_flaky_subprocess(argv, attempt_setup=f,
    **subprocess_kwargs)``; ``attempt_setup(attempt)`` (if given) runs
    before each try and returns extra argv entries — use it to point
    every attempt at fresh scratch state.  Returns the final
    `CompletedProcess`; only NEGATIVE returncodes (signal deaths) are
    retried, so assertion failures surface on the first attempt.
    """
    marker = request.node.get_closest_marker("flaky_subprocess")
    if marker is None:
        raise pytest.UsageError(
            "run_flaky_subprocess requires @pytest.mark.flaky_subprocess "
            "on the test (the marker IS the quarantine registry)")
    retries = marker.kwargs.get("retries", 3)

    def run(argv, attempt_setup=None, **kwargs):
        def on_retry(attempt, att):
            print(f"[flaky_subprocess] {request.node.name}: native crash "
                  f"(signal {att.signal}), attempt "
                  f"{attempt + 1}/{retries}")

        # delegates to the library supervisor (launch/supervise.py) the
        # prover service uses in production: signal deaths retry with
        # capped exponential backoff (the native crash is load-sensitive
        # — let the machine settle), clean exits return immediately
        res = run_subprocess_supervised(
            list(argv), max_attempts=retries, attempt_setup=attempt_setup,
            backoff_base=2.0, backoff_cap=6.0, retry_nonzero=False,
            retry_timeouts=False, on_retry=on_retry, **kwargs)
        return res.value

    return run
