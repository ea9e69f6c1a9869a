"""Hand-written CUDA kernels of the port (sm_90a), one directory each.

* ``modmul``          -- elementwise Montgomery multiply (replaces the
                         Pallas ``modmul_planes``); every on-card field
                         and group product of the port runs through it.
* ``sumcheck_fold``   -- the sumcheck variable fold, the IPA halves
                         fold and the IPA generator fold (replace
                         ``fold_planes``, ``fold_halves_planes`` and
                         ``pow_mul_planes``).
* ``validity_tables`` -- both zkReLU eq. (19) tables in one launch
                         (replaces ``validity_tables_planes``).
* ``generators``      -- hash-to-group generator derivation, the port's
                         own kernel (the reference derives on the host).
* ``qmatmul``         -- the exact int16 x int16 -> int64 matmul in one
                         launch on the int8 tensor cores (replaces
                         ``qmatmul_digits`` and its wrapper's assembly);
                         every witness matmul on the card runs through it.
* ``msm``             -- multi-scalar multiplication, the port's own
                         kernel (the reference's MSM is jnp code): on the
                         card every MSM of `core.group` (commits, IPA
                         rounds, the verifier's multi-exponentiations)
                         runs through it; on the CPU the sort-based
                         Pippenger in torch ops stays.

Each directory holds the ``.cu`` source and an ``ops.py`` with the
wrapper, its plain PyTorch version (used for CPU tensors, and as the
oracle the kernel is held against on the card) and a launch counter.
`_build` compiles the sources with nvcc on first use.
"""
from __future__ import annotations


def _wrappers() -> dict:
    from repro_torch.kernels.generators.ops import derive
    from repro_torch.kernels.modmul.ops import modmul
    from repro_torch.kernels.msm.ops import msm
    from repro_torch.kernels.qmatmul.ops import qmatmul_i64
    from repro_torch.kernels.sumcheck_fold.ops import (fold, fold_halves,
                                                       pow_mul_halves)
    from repro_torch.kernels.validity_tables.ops import build_tables
    return {"modmul": modmul, "fold": fold, "fold_halves": fold_halves,
            "validity_tables": build_tables, "generators": derive,
            "pow_mul": pow_mul_halves, "qmatmul": qmatmul_i64, "msm": msm}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
