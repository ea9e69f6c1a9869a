"""Wrappers of the exact int16 matmul kernel (`qmatmul.cu`).

``qmatmul_i64`` is the exact int16 x int16 -> int64 product.  On CUDA
tensors it is one launch of the fused kernel, which splits the operands
into int8 digits in registers, runs the four digit products on the int8
tensor cores and assembles and writes the int64 result; the operands are
read as they lie, row-major or as ``.T`` views.  On CPU tensors it runs
its plain version, which mirrors the reference
(`repro.kernels.qmatmul.ops`): the digit split x_hi = x >> 8,
x_c = (x & 0xFF) - 128 (both int8), the four digit products and the
rank-1 correction sums, assembled as

    A @ B = 2^16 hh + 2^8 (hc + ch) + cc
          + 2^15 rowsum(Ah) + 2^7 rowsum(Ac)
          + 2^15 colsum(Bh) + 2^7 colsum(Bc) + 2^14 K

K is padded with int16 zeros to ``K_TILE``.  A zero pad splits into
x_hi = 0 and x_c = -128, so the digit products and sums are not zero over
the pad; the identity still holds for the padded operands, so the
assembly uses the padded K (the reference's rule,
`repro/kernels/qmatmul/ops.py:13-18`).  The plain version keeps the digit
products and sums in int64, so it is exact for every accepted K; the
reference's int32 digit sums overflow at K = 2^17.

``digit_operands``, ``qmatmul_digits`` and ``qmatmul_partials`` are the
reference's digit decomposition in plain PyTorch, for the CPU: the card
computes the product in one launch of ``qmatmul_i64`` and has no digit
kernel.  CUDA has no integer ``torch.matmul``, so the card's plain
version runs on CPU copies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: the plain version's K tile in int8 digits (K is padded to a multiple)
K_TILE = 32
#: the largest contraction length accepted (the kernel's int32 digit products
#: are recovered exactly up to here; reference ops.py:76)
K_MAX = 1 << 17


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int16 or b.dtype != torch.int16:
        raise TypeError(f"qmatmul: expected int16 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"qmatmul: expected (M, K) x (K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.shape[1] > K_MAX:
        raise ValueError(f"qmatmul: K = {a.shape[1]} exceeds K_MAX = "
                         f"{K_MAX}")
    if a.device != b.device:
        raise ValueError(f"qmatmul: operands on {a.device} and {b.device}")


def split_digits(x: torch.Tensor):
    """int16 -> (x_hi, x_c), both int8, with x = 256 x_hi + x_c + 128."""
    x = x.to(torch.int32)
    return (x >> 8).to(torch.int8), ((x & 0xFF) - 128).to(torch.int8)


def digit_operands(a: torch.Tensor, b: torch.Tensor):
    """(M, K) x (K, N) int16 -> the digit operands: A digits (M, K_pad)
    and B digits transposed (N, K_pad), all contiguous int8, and K_pad."""
    _check_operands(a, b)
    pad = (-a.shape[1]) % K_TILE
    if pad:
        a = F.pad(a, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    a_hi, a_c = split_digits(a)
    bt_hi, bt_c = split_digits(b.T)
    return (a_hi.contiguous(), a_c.contiguous(), bt_hi.contiguous(),
            bt_c.contiguous(), a.shape[1])


def _digit_products(a_hi, a_c, bt_hi, bt_c):
    """The four digit products as exact int64 matmuls."""
    def mm(x, yt):
        return x.to(torch.int64) @ yt.to(torch.int64).T
    return mm(a_hi, bt_hi), mm(a_hi, bt_c), mm(a_c, bt_hi), mm(a_c, bt_c)


def qmatmul_digits_plain(a_hi, a_c, bt_hi, bt_c):
    """The four digit products, returned as int32 like the reference's."""
    return tuple(p.to(torch.int32)
                 for p in _digit_products(a_hi, a_c, bt_hi, bt_c))


def qmatmul_digits(a_hi, a_c, bt_hi, bt_c):
    """A digits (M, K_pad), B digits transposed (N, K_pad), int8 ->
    (hh, hc, ch, cc), each (M, N) int32.  CPU tensors only."""
    if a_hi.device.type != "cpu":
        raise RuntimeError("qmatmul_digits: the card has no digit kernel; "
                           "qmatmul_i64 computes the exact product in one "
                           "launch")
    return qmatmul_digits_plain(a_hi, a_c, bt_hi, bt_c)


def qmatmul_partials(a: torch.Tensor, b: torch.Tensor):
    """(M, K) x (K, N) int16 -> ((hh, hc, ch, cc, rs_h, rs_c, cs_h, cs_c),
    k_pad): the digit products and the row / column digit sums, all
    int32, the sums over the padded contraction length ``k_pad``."""
    a_hi, a_c, bt_hi, bt_c, k_pad = digit_operands(a, b)
    hh, hc, ch, cc = qmatmul_digits(a_hi, a_c, bt_hi, bt_c)
    sums = [d.sum(dim=1, dtype=torch.int32) for d in (a_hi, a_c, bt_hi, bt_c)]
    return (hh, hc, ch, cc, *sums), k_pad


def qmatmul_i64_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int64 product assembled from the reference's digits,
    every digit product and sum in int64."""
    a_hi, a_c, bt_hi, bt_c, k_pad = digit_operands(a, b)
    hh, hc, ch, cc = _digit_products(a_hi, a_c, bt_hi, bt_c)
    rs_h, rs_c, cs_h, cs_c = (d.sum(dim=1, dtype=torch.int64)
                              for d in (a_hi, a_c, bt_hi, bt_c))
    out = hh * (1 << 16) + (hc + ch) * (1 << 8) + cc
    out += (rs_h * (1 << 15) + rs_c * (1 << 7))[:, None]
    out += (cs_h * (1 << 15) + cs_c * (1 << 7))[None, :]
    return out + k_pad * (1 << 14)


def _layout(x: torch.Tensor, k_axis: int):
    """(x, ld, kmajor): an operand as the kernel reads it, K-contiguous
    (kmajor) or contiguous along its other axis, with the stride ``ld`` of
    the non-contiguous axis; other strides are made contiguous."""
    o_axis = 1 - k_axis
    if x.stride(k_axis) == 1 or x.shape[k_axis] == 1:
        return x, x.stride(o_axis), True
    if x.stride(o_axis) == 1 or x.shape[o_axis] == 1:
        return x, x.stride(k_axis), False
    x = x.contiguous()
    return _layout(x, k_axis)


def qmatmul_i64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 product of two int16 matrices, on their device."""
    _check_operands(a, b)
    if a.device.type == "cpu":
        return qmatmul_i64_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"qmatmul_i64: expected a CUDA or CPU tensor, got "
                         f"{a.device}")
    (m, k), n = a.shape, b.shape[1]
    if k == 0:
        return torch.zeros((m, n), dtype=torch.int64, device=a.device)
    out = torch.empty((m, n), dtype=torch.int64, device=a.device)
    if m == 0 or n == 0:
        return out
    a, a_ld, a_kmajor = _layout(a, 1)
    b, b_ld, b_kmajor = _layout(b, 0)
    err = _build.lib("qmatmul").zk_qmatmul_i64(
        a.data_ptr(), a_ld, int(a_kmajor), b.data_ptr(), b_ld,
        int(b_kmajor), out.data_ptr(), m, n, k,
        _build.stream_handle(a.device))
    _build.check(err, "qmatmul_i64")
    qmatmul_i64.launches += 1
    return out


qmatmul_i64.launches = 0
