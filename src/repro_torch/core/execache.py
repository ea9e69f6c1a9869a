"""The kernel build cache, with the reference's executable-cache contract.

The reference (`repro.core.execache`) caches traced and compiled XLA
executables in the process and on disk, so a fresh process neither
re-traces nor re-compiles.  The port has no traced programs: its only
compiled artifacts are the CUDA kernel libraries, which
`repro_torch.kernels._build` names by a hash of their sources and nvcc
flags and keeps in ``build/kernels/`` at the repository root.  This
module reports what that cache did, under the reference's counter names:

* ``hits``: a kernel call found its library already loaded in this
  process;
* ``misses``: a source compiled by ``nvcc`` in this process;
* ``disk_hits``: a library loaded from ``build/kernels/``;
* ``disk_writes``: a freshly compiled library written there;
* ``disk_corrupt``: a library file whose SHA-256 does not match the
  digest written beside it (a truncated library), or that failed to
  load, deleted and rebuilt (neither a crash nor a fall back to the
  plain versions).

A process that finds every library on disk reports ``misses == 0`` and
``disk_writes == 0``: the cross-process "builds nothing" contract.  The
reference's ``wrap`` has no counterpart, since no traced programs exist;
``enabled`` neither, since the kernels cannot run uncompiled.
"""
from __future__ import annotations

from repro_torch.kernels import _build


def stats() -> dict:
    """A copy of this process's build-cache counters."""
    with _build._lock:
        return dict(_build.stats)


def reset_stats() -> None:
    with _build._lock:
        for k in _build.stats:
            _build.stats[k] = 0


def clear() -> None:
    """Drop the in-process registry of loaded libraries (disk entries
    stay): the next kernel call loads its library from disk again."""
    with _build._lock:
        _build._libs.clear()


def cache_dir() -> str:
    """The directory that holds the built kernel libraries."""
    return str(_build.BUILD_DIR)
