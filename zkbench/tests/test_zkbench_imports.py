"""The import guard: nothing the benchmark loads is JAX or the JAX
package (top-level names compared whole), the reference loads nothing
of the program either, and nothing reads the old `benchmarks/`."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    tops = set(_imports(path))
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert tops <= {"__future__", "hashlib", "struct", "typing",
                        "torch", "zkbench"}
    assert "benchmarks/" not in path.read_text()


def test_loaded_modules():
    """Import every module a run loads (the program's path included)
    in a fresh process and list the top-level names."""
    code = (
        "import sys, runpy, pathlib\n"
        "from zkbench import harness, tracing, control\n"
        "from zkbench.drivers import train_prove_verify\n"
        "for p in sorted(pathlib.Path(harness.BENCH_DIR, 'metrics')"
        ".glob('*.py')):\n"
        "    if p.stem != '__init__': harness.load_module('metrics', p.stem)\n"
        "from repro_torch.core.pipeline import api, proofio, verifier\n"
        "from repro_torch.launch import steps\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'repro', "
        "'benchmarks'}))\n")
    root = BENCH.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "src")]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_reference_alone():
    """The reference imports in a process with nothing of the program."""
    code = ("import sys\n"
            "from zkbench.reference import sgd, proofcheck\n"
            "print(sorted(m for m in {n.split('.')[0] for n in sys.modules}"
            " if m.startswith('repro') or m == 'jax'))\n")
    root = BENCH.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
