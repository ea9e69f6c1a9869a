"""Shared field-table helpers for the staged proof pipeline.

All proof tensors are flat ``(n,)`` int64 Montgomery word tables (see
`repro_torch.core.mle` for the variable ordering).  The helpers here are
the witness-to-table plumbing every stage shares: encoding int64
tensors, fixing row/column variable blocks (through the sumcheck_fold
kernel), Kronecker products of expanded points, and sparse "weight"
tables over the stacked (step, layer) slot axis.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.field import FQ, decode, encode_i64, mont_mul
from repro_torch.core.mle import enc, enc_vec
from repro_torch.kernels.sumcheck_fold import fold as _kernel_fold

Q_MOD = FQ.modulus


def next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def log2_exact(n: int) -> int:
    assert n & (n - 1) == 0
    return n.bit_length() - 1


def rand_scalar(rng) -> int:
    return int(rng.integers(0, Q_MOD, dtype=np.uint64)) % Q_MOD


def enc_tensor(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> flat (n,) Montgomery table on its device."""
    return encode_i64(FQ, x.reshape(-1))


def dec_scalar(x: torch.Tensor) -> int:
    return int(decode(FQ, x.reshape(()))[()])


def dec_scalars(x: torch.Tensor) -> List[int]:
    """(k,) table -> k python ints, one host transfer."""
    return [int(v) for v in decode(FQ, x.reshape(-1))]


def kron_many(his: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Batched `kron`: (k, a) x (b,) -> (k, a*b)."""
    out = mont_mul(FQ, his[:, :, None], lo[None, None, :])
    return out.reshape(his.shape[0], -1)


def fix_rows(table: torch.Tensor, point: List[int]) -> torch.Tensor:
    """table (R, C); fold ROW vars (little-endian) -> (C,)."""
    for r in point:
        table = _kernel_fold(table, enc(r), inner=table.shape[1])
    return table[0]


def fix_cols(table: torch.Tensor, point: List[int]) -> torch.Tensor:
    """table (R, C); fold COL vars -> (R,)."""
    rows = table.shape[0]
    for r in point:
        table = _kernel_fold(table, enc(r)).reshape(rows, -1)
    return table[:, 0]


def kron(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(a,) x (b,) -> (a*b,) with lo varying fastest (low MLE vars)."""
    return mont_mul(FQ, hi[:, None], lo[None, :]).reshape(-1)


def weight_table(weights: Dict[int, int], n: int, device) -> torch.Tensor:
    """Sparse coefficient vector over an n-slot axis as a field table."""
    vec = [0] * n
    for i, w in weights.items():
        vec[i] = w % Q_MOD
    return enc_vec(vec, device)


def wt_eval(weights: Dict[int, int], e_host: List[int]) -> int:
    """<weights, e(u)> for a host-expanded point (verifier side)."""
    return sum(w * e_host[i] for i, w in weights.items()) % Q_MOD
