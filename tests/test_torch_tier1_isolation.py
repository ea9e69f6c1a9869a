"""The harness the tier-1 run depends on (the repo-root conftest.py):
every in-process test sees one host device, whatever collection
imported (tests/test_roofline.py imports repro.launch.dryrun, which
prepends --xla_force_host_platform_device_count=512 to XLA_FLAGS) and
whatever ran before it (tests/test_bench_imports.py imports
benchmarks/perf.py, which does the same); and the `slow` list names only
tests that exist."""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROBE = "tests/test_torch_tier1_isolation.py::test_field_jit_sees_one_device"


@pytest.fixture
def slow_list(pytestconfig):
    return pytestconfig.pluginmanager.get_plugin(
        str(ROOT / "conftest.py")).SLOW


def _pytest(args, tmp_path, timeout):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu",
               ZKDL_EXEC_CACHE=str(tmp_path / "exec"))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_field_jit_sees_one_device():
    from repro.field import FQ, decode, encode_ints, mont_mul
    assert jax.device_count() == 1, jax.devices()
    xs = [3, FQ.modulus - 1, 2**60]
    a = encode_ints(FQ, np.array(xs, dtype=object))
    got = [int(v) for v in decode(FQ, np.asarray(mont_mul(FQ, a, a)))]
    assert got == [x * x % FQ.modulus for x in xs]


def test_one_device_after_the_512_device_imports(tmp_path):
    """Collect test_roofline (dryrun at import), run the benchmark
    import sweep (perf at test time), then jit a field function in the
    same process: the order that failed with "Expected args to
    execute_sharded_on_local_devices to have 512 shards, got: [1]"."""
    proc = _pytest(
        ["-rA", "tests/test_roofline.py", "tests/test_bench_imports.py",
         PROBE, "--deselect",
         "tests/test_roofline.py::test_costmodel_matches_unrolled_hlo"],
        tmp_path, timeout=600)
    out = (proc.stdout + proc.stderr)[-4000:]
    assert proc.returncode == 0, out
    assert f"PASSED {PROBE}" in proc.stdout, out


def test_slow_list_is_collected(slow_list, tmp_path):
    """A renamed or deleted test must not leave a stale entry behind."""
    for node, (seconds, where) in slow_list.items():
        assert float(seconds.lstrip(">")) > 60 and where, node
        assert not node.startswith("tests/test_torch_"), node
    proc = _pytest(["--collect-only", *slow_list], tmp_path, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    collected = set(proc.stdout.splitlines())
    assert not [n for n in slow_list if n not in collected]
