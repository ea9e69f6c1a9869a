"""The benchmark's CPU tests: the repository root and ``src`` on the
path, and the ``gpu`` marker for tests that need the card (each decides
inside the test whether there is one)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips itself "
        "without one")
