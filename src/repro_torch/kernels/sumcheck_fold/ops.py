"""Wrappers of the fold kernels (`sumcheck_fold.cu`) and their plain
versions: the sumcheck variable fold and the IPA halves fold over FQ,
and the IPA generator fold lo^{e_lo} * hi^{e_hi} over FP.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  Scalars (r, c_lo, c_hi) are canonical Montgomery-form python
ints and exponents standard-form python ints below 2^61, passed to the
kernels by value.
"""
from __future__ import annotations

import torch

from repro_torch.field.modarith import FP, FQ, add, mont_mul_plain, sub
from repro_torch.kernels import _build
from repro_torch.kernels.modmul.ops import _check_cuda


def _rows(x: torch.Tensor, inner: int):
    n = x.numel()
    assert n % (2 * inner) == 0, (x.shape, inner)
    return n // (2 * inner)


def fold_plain(x: torch.Tensor, r: int, inner: int = 1) -> torch.Tensor:
    """x viewed as (outer, 2, inner) -> (outer, inner):
    even + (odd - even) * r."""
    outer = _rows(x, inner)
    v = x.reshape(outer, 2, inner)
    ev, od = v[:, 0], v[:, 1]
    rt = torch.tensor(int(r), dtype=torch.int64, device=x.device)
    return add(FQ, ev, mont_mul_plain(FQ, sub(FQ, od, ev), rt))


def fold(x: torch.Tensor, r: int, inner: int = 1) -> torch.Tensor:
    """Fix one MLE variable at r: pairs (x[2o, j], x[2o+1, j]) of the
    (outer, 2, inner) view fold to out[o, j].  ``inner = 1`` folds the
    lowest variable of every row of a (K, n) stack; returns (outer, inner)."""
    if x.device.type == "cpu":
        return fold_plain(x, r, inner)
    _check_cuda(x, "fold")
    outer = _rows(x, inner)
    x = x.contiguous()
    out = torch.empty((outer, inner), dtype=torch.int64, device=x.device)
    err = _build.lib("sumcheck_fold").zk_fold(
        x.data_ptr(), out.data_ptr(), outer, inner, int(r), FQ.modulus,
        FQ.nprime64, _build.stream_handle(x.device))
    _build.check(err, "fold")
    fold.launches += 1
    return out


def fold_halves_plain(vec: torch.Tensor, c_lo: int,
                      c_hi: int) -> torch.Tensor:
    n2 = vec.shape[0] // 2
    lo_t = torch.tensor(int(c_lo), dtype=torch.int64, device=vec.device)
    hi_t = torch.tensor(int(c_hi), dtype=torch.int64, device=vec.device)
    return add(FQ, mont_mul_plain(FQ, vec[:n2], lo_t),
               mont_mul_plain(FQ, vec[n2:], hi_t))


def fold_halves(vec: torch.Tensor, c_lo: int, c_hi: int) -> torch.Tensor:
    """The IPA scalar fold: (n,) -> (n/2,) c_lo * vec[:n/2] + c_hi * vec[n/2:]
    with Montgomery-form coefficients."""
    n = vec.shape[0]
    assert vec.dim() == 1 and n % 2 == 0, vec.shape
    if vec.device.type == "cpu":
        return fold_halves_plain(vec, c_lo, c_hi)
    _check_cuda(vec, "fold_halves")
    vec = vec.contiguous()
    out = torch.empty(n // 2, dtype=torch.int64, device=vec.device)
    err = _build.lib("sumcheck_fold").zk_fold_halves(
        vec.data_ptr(), vec[n // 2:].data_ptr(), out.data_ptr(), n // 2,
        int(c_lo), int(c_hi), FQ.modulus, FQ.nprime64,
        _build.stream_handle(vec.device))
    _build.check(err, "fold_halves")
    fold_halves.launches += 1
    return out


def _pow_plain(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e over FP by square-and-multiply on the plain multiply."""
    if e == 1:
        return x
    res = torch.full_like(x, FP.one)
    acc = x
    for j in range(e.bit_length()):
        if (e >> j) & 1:
            res = mont_mul_plain(FP, res, acc)
        if j + 1 < e.bit_length():
            acc = mont_mul_plain(FP, acc, acc)
    return res


def _check_exponent(e) -> int:
    e = int(e)
    if not 0 <= e < (1 << 61):
        raise ValueError(f"pow_mul: exponent {e} is not a standard-form "
                         "61-bit value")
    return e


def pow_mul_plain(gens: torch.Tensor, e_lo: int, e_hi: int) -> torch.Tensor:
    n2 = gens.shape[0] // 2
    e_lo, e_hi = _check_exponent(e_lo), _check_exponent(e_hi)
    return mont_mul_plain(FP, _pow_plain(gens[:n2], e_lo),
                          _pow_plain(gens[n2:], e_hi))


def pow_mul_halves(gens: torch.Tensor, e_lo: int, e_hi: int) -> torch.Tensor:
    """The IPA generator fold: (n,) FP group elements and two standard-form
    exponents -> (n/2,) gens[:n/2]^{e_lo} * gens[n/2:]^{e_hi}."""
    n = gens.shape[0]
    assert gens.dim() == 1 and n % 2 == 0, gens.shape
    if gens.device.type == "cpu":
        return pow_mul_plain(gens, e_lo, e_hi)
    _check_cuda(gens, "pow_mul_halves")
    e_lo, e_hi = _check_exponent(e_lo), _check_exponent(e_hi)
    gens = gens.contiguous()
    out = torch.empty(n // 2, dtype=torch.int64, device=gens.device)
    err = _build.lib("sumcheck_fold").zk_pow_mul(
        gens.data_ptr(), gens[n // 2:].data_ptr(), out.data_ptr(), n // 2,
        e_lo, e_hi, FP.one, FP.modulus, FP.nprime64,
        _build.stream_handle(gens.device))
    _build.check(err, "pow_mul_halves")
    pow_mul_halves.launches += 1
    return out


fold.launches = 0
fold_halves.launches = 0
pow_mul_halves.launches = 0
