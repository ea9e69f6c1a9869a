"""Shared utilities: timers (the reference's `repro.util`).

The reference's other name, ``enable_compilation_cache``, points JAX at
a persistent XLA executable cache.  It has no counterpart here: the
port compiles nothing per graph, and its CUDA libraries persist in the
kernel build cache (`repro_torch.core.execache`, ``build/kernels/``).
"""
from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def timer(label: str, sink: dict | None = None):
    """Add the wall seconds of the ``with`` body to ``sink[label]``."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt
