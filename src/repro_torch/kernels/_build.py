"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel directory holds one ``.cu`` file with a plain C interface
(no PyTorch headers, so each compiles in seconds).  The first kernel
call of a process builds every source at once, one ``nvcc`` process per
source started together, into ``build/kernels/`` at the repository root
(listed in ``.gitignore``); the library name carries a hash of the
sources and flags, so an unchanged tree reuses its libraries.  Nothing
is built when a module is imported: the CPU tests import every module
and never call a kernel.  `repro_torch.core.execache` reports what the
cache did (``stats``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

KERNEL_DIR = pathlib.Path(__file__).resolve().parent
REPO_ROOT = KERNEL_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

#: kernel library name -> source file relative to this directory
SOURCES = {
    "modmul": "modmul/modmul.cu",
    "sumcheck_fold": "sumcheck_fold/sumcheck_fold.cu",
    "validity_tables": "validity_tables/validity_tables.cu",
    "generators": "generators/generators.cu",
    "qmatmul": "qmatmul/qmatmul.cu",
    "msm": "msm/msm.cu",
}
HEADERS = ("mont64.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_INT = ctypes.c_int
#: C signatures of the exported launchers (argtypes; every one returns
#: the cudaError_t of its launch as an int)
SIGNATURES = {
    "zk_modmul": (_P, _I64, _P, _I64, _P, _I64, _U64, _U64, _P),
    "zk_modmul_scalar": (_P, _U64, _P, _I64, _U64, _U64, _P),
    "zk_fold": (_P, _P, _I64, _I64, _U64, _U64, _U64, _P),
    "zk_fold_halves": (_P, _P, _P, _I64, _U64, _U64, _U64, _U64, _P),
    "zk_pow_mul": (_P, _P, _P, _I64, _U64, _U64, _U64, _U64, _U64, _P),
    "zk_qmatmul_i64": (_P, _I64, _INT, _P, _I64, _INT, _P, _I64, _I64, _I64,
                       _P),
    "zk_validity_tables": (_P,) * 10 + (_I64,) + (_U64,) * 6 + (_P,),
    "zk_derive_generators": (_P, _INT, _I64, _I64, _P, _U64, _U64, _U64,
                             _P),
    "zk_msm": (_P, _INT, _P, _P, _I64, _I64, _I64, _INT, _INT, _U64, _U64,
               _U64, _U64, _P, _P, _P),
}

_lock = threading.Lock()
_libs: dict = {}
#: build-cache counters of this process (`repro_torch.core.execache`)
stats = {"hits": 0, "misses": 0, "disk_hits": 0, "disk_writes": 0,
         "disk_corrupt": 0}
#: seconds spent in the last `build_all` and the compiler's reports
build_log: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda)")
    return path


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in (SOURCES[name],) + HEADERS:
        h.update((KERNEL_DIR / rel).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _digest_path(path: pathlib.Path) -> pathlib.Path:
    return path.with_name(path.name + ".sha256")


def _intact(path: pathlib.Path) -> bool:
    """The library file is the one this cache wrote: its SHA-256 equals
    the digest written beside it.  A truncated library must not reach
    the loader: mapping one can kill the process (SIGBUS) instead of
    raising."""
    try:
        want = _digest_path(path).read_text().strip()
        return want == hashlib.sha256(path.read_bytes()).hexdigest()
    except OSError:
        return False


def _load(path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all() -> dict:
    """Load every kernel library, compiling the sources that have none
    on disk (all ``nvcc`` processes started together).  A library file
    whose digest does not match (`_intact`) or that fails to load is
    counted, deleted and rebuilt.  Returns ``{name: ctypes.CDLL}``.
    Raises if a compile fails."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = []
        for name in SOURCES:
            if name in _libs:
                continue
            path = _lib_path(name)
            if path.exists():
                if _intact(path):
                    try:
                        _libs[name] = _load(path)
                        stats["disk_hits"] += 1
                        continue
                    except OSError:      # a foreign file
                        pass
                stats["disk_corrupt"] += 1
                path.unlink(missing_ok=True)
            todo.append(name)
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            out = _lib_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, f"-I{KERNEL_DIR}", "-o", str(tmp),
                   str(KERNEL_DIR / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            stats["misses"] += 1
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
                digest = _digest_path(out).with_suffix(f".{os.getpid()}.tmp")
                digest.write_text(
                    hashlib.sha256(out.read_bytes()).hexdigest() + "\n")
                os.replace(digest, _digest_path(out))
                stats["disk_writes"] += 1
        build_log["seconds"] = time.perf_counter() - t0
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for name in todo:
            _libs[name] = _load(_lib_path(name))
        return dict(_libs)


def lib(name: str) -> ctypes.CDLL:
    loaded = _libs.get(name)
    if loaded is not None:
        with _lock:
            stats["hits"] += 1
        return loaded
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise on a refused launch (the C launcher returns cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
