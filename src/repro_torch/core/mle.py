"""Multilinear-extension utilities over the proof field FQ.

Tables are flat ``(n,)`` int64 word tensors in Montgomery form with
n = 2^d.  Variable ordering is little-endian: variable j of the MLE
corresponds to bit j of the flat index, so folding variable 0 pairs
adjacent entries ``(table[2i], table[2i+1])``.

A point is a list of python ints (canonical field values, produced by the
transcript); scalars enter the kernels by value in Montgomery form
(`enc`).
"""
from __future__ import annotations

import torch

from repro_torch.field import FQ, encode_int, encode_ints, mont_mul
from repro_torch.field import fsum as _fsum
from repro_torch.kernels.sumcheck_fold import fold as _kernel_fold

Q = FQ.modulus


def enc(x: int) -> int:
    """Python int -> its Montgomery-form canonical int."""
    return encode_int(FQ, int(x))


def enc_vec(xs, device) -> torch.Tensor:
    return encode_ints(FQ, [int(x) for x in xs], device=device)


def fold(table: torch.Tensor, r_m: int) -> torch.Tensor:
    """Fix MLE variable 0 (lowest bit) at r (Montgomery int): (n,) -> (n/2,).
    Runs the sumcheck_fold kernel on the card."""
    assert table.shape[0] % 2 == 0
    return _kernel_fold(table, r_m).reshape(-1)


def expand_point(point_ints, device) -> torch.Tensor:
    """e(u): (2^d,) table with e_i = prod_j (u_j if bit_j(i) else 1-u_j).
    The new coordinate occupies the HIGH bit, so coordinate j stays
    aligned with bit j of the flat index."""
    e = torch.full((1,), FQ.one, dtype=torch.int64, device=device)
    for u in point_ints:
        e = torch.cat([mont_mul(FQ, e, enc(1 - u)), mont_mul(FQ, e, enc(u))])
    return e


def fsum(table: torch.Tensor) -> torch.Tensor:
    """Field sum of all entries: returns a 0-d tensor."""
    return _fsum(FQ, table.reshape(-1))


def fdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product of two (n,) tables: returns a 0-d tensor."""
    return fsum(mont_mul(FQ, a, b))


def weighted_sum(tables: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """sum_k coefs[k] * tables[k] for (k, n) tables and (k,) coefs."""
    return _fsum(FQ, mont_mul(FQ, tables, coefs[:, None]), dim=0)


def fdot_many(table: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """<table, bases[k]> for each k: (n,) x (k, n) -> (k,)."""
    return _fsum(FQ, mont_mul(FQ, bases, table[None]), dim=-1)


# ---------------------------------------------------------------------------
# Host-side (verifier) modular arithmetic over FQ as python ints.
# ---------------------------------------------------------------------------

def hadd(x, y):
    return (x + y) % Q


def hsub(x, y):
    return (x - y) % Q


def hmul(x, y):
    return (x * y) % Q


def hinv(x):
    return pow(x, Q - 2, Q)


def hneg(x):
    return (-x) % Q


def heval_point_product(point_a, point_b):
    """beta~(a, b) = prod_j (a_j b_j + (1-a_j)(1-b_j)) for int points."""
    acc = 1
    for a, b in zip(point_a, point_b):
        acc = acc * ((a * b + (1 - a) * (1 - b)) % Q) % Q
    return acc % Q


def hexpand_point(point_ints):
    """Host e(u) as python-int list (small points only)."""
    e = [1]
    for u in point_ints:
        lo = [(x * (1 - u)) % Q for x in e]
        hi = [(x * u) % Q for x in e]
        e = lo + hi
    return e


def lagrange_eval(ys, x):
    """Evaluate the degree-(k-1) poly through points (0..k-1, ys) at x (ints)."""
    k = len(ys)
    acc = 0
    for i in range(k):
        num, den = 1, 1
        for j in range(k):
            if i == j:
                continue
            num = num * ((x - j) % Q) % Q
            den = den * ((i - j) % Q) % Q
        acc = (acc + ys[i] * num % Q * hinv(den)) % Q
    return acc


def eval_mle(table: torch.Tensor, point_ints) -> torch.Tensor:
    """Evaluate the MLE of ``table`` at ``point`` (python ints,
    little-endian): one fold per coordinate.  Returns a 0-d tensor."""
    n = table.shape[0]
    assert n == 1 << len(point_ints), (n, len(point_ints))
    for r in point_ints:
        table = fold(table, enc(r))
    return table[0]
