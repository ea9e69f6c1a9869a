"""Wrappers of the exact int16 matmul kernel (`qmatmul.cu`).

``qmatmul_partials`` mirrors the reference (`repro.kernels.qmatmul.ops`):
the digit split x_hi = x >> 8, x_c = (x & 0xFF) - 128 (both int8), the
four digit products of `qmatmul_digits` and the rank-1 correction sums.
``qmatmul_i64`` assembles the exact int64 product on the operands' own
device:

    A @ B = 2^16 hh + 2^8 (hc + ch) + cc
          + 2^15 rowsum(Ah) + 2^7 rowsum(Ac)
          + 2^15 colsum(Bh) + 2^7 colsum(Bc) + 2^14 K

K is padded with int16 zeros to the kernel's K tile.  A zero pad splits
into x_hi = 0 and x_c = -128, so the digit products and sums are not zero
over the pad; the identity still holds for the padded operands, so the
assembly uses the padded K that the digit sums ran over (the reference's
rule, `repro/kernels/qmatmul/ops.py:13-18`).  ``K_pad <= 2^17`` keeps every
int32 digit sum exact.

`qmatmul_digits` on CPU tensors runs its plain version (int64 matmuls of
the digits); on CUDA tensors it launches the kernel or raises.  CUDA has
no integer ``torch.matmul``, so on the card the plain version runs on CPU
copies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: the kernel's K tile in int8 digits (K is padded to a multiple of it)
K_TILE = 32
#: the int32 accumulator bound (reference ops.py:76)
K_MAX = 1 << 17


def split_digits(x: torch.Tensor):
    """int16 -> (x_hi, x_c), both int8, with x = 256 x_hi + x_c + 128."""
    x = x.to(torch.int32)
    return (x >> 8).to(torch.int8), ((x & 0xFF) - 128).to(torch.int8)


def digit_operands(a: torch.Tensor, b: torch.Tensor):
    """(M, K) x (K, N) int16 -> the kernel's operands: A digits (M, K_pad)
    and B digits transposed (N, K_pad), all contiguous int8, and K_pad."""
    if a.dtype != torch.int16 or b.dtype != torch.int16:
        raise TypeError(f"qmatmul: expected int16 operands, got {a.dtype} "
                        f"and {b.dtype}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"qmatmul: inner sizes differ: {a.shape} x "
                         f"{b.shape}")
    pad = (-k) % K_TILE
    k_pad = k + pad
    assert k_pad <= K_MAX, "int32 accumulator bound requires K <= 2^17"
    if pad:
        a = F.pad(a, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    a_hi, a_c = split_digits(a)
    bt_hi, bt_c = split_digits(b.T)
    return (a_hi.contiguous(), a_c.contiguous(), bt_hi.contiguous(),
            bt_c.contiguous(), k_pad)


def qmatmul_digits_plain(a_hi, a_c, bt_hi, bt_c):
    """The four digit products as int64 matmuls, returned as int32."""
    def mm(x, yt):
        return (x.to(torch.int64) @ yt.to(torch.int64).T).to(torch.int32)
    return mm(a_hi, bt_hi), mm(a_hi, bt_c), mm(a_c, bt_hi), mm(a_c, bt_c)


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype != torch.int8 or not t.is_contiguous():
        raise TypeError(f"{what}: expected contiguous int8 digits, got "
                        f"{t.dtype}")


def qmatmul_digits(a_hi, a_c, bt_hi, bt_c):
    """A digits (M, K_pad), B digits transposed (N, K_pad), int8 ->
    (hh, hc, ch, cc), each (M, N) int32, in one launch on the card."""
    if a_hi.device.type == "cpu":
        return qmatmul_digits_plain(a_hi, a_c, bt_hi, bt_c)
    for t in (a_hi, a_c, bt_hi, bt_c):
        _check(t, "qmatmul_digits")
    (m, k_pad), (n, k2) = a_hi.shape, bt_hi.shape
    if k_pad != k2 or k_pad % K_TILE or a_c.shape != a_hi.shape \
            or bt_c.shape != bt_hi.shape:
        raise ValueError(f"qmatmul_digits: bad digit shapes {a_hi.shape}, "
                         f"{bt_hi.shape}")
    outs = [torch.empty((m, n), dtype=torch.int32, device=a_hi.device)
            for _ in range(4)]
    err = _build.lib("qmatmul").zk_qmatmul_digits(
        a_hi.data_ptr(), a_c.data_ptr(), bt_hi.data_ptr(), bt_c.data_ptr(),
        *(o.data_ptr() for o in outs), m, n, k_pad,
        _build.stream_handle(a_hi.device))
    _build.check(err, "qmatmul_digits")
    qmatmul_digits.launches += 1
    return tuple(outs)


def qmatmul_partials(a: torch.Tensor, b: torch.Tensor):
    """(M, K) x (K, N) int16 -> ((hh, hc, ch, cc, rs_h, rs_c, cs_h, cs_c),
    k_pad): the digit products and the row / column digit sums, all
    int32, the sums over the padded contraction length ``k_pad``."""
    a_hi, a_c, bt_hi, bt_c, k_pad = digit_operands(a, b)
    hh, hc, ch, cc = qmatmul_digits(a_hi, a_c, bt_hi, bt_c)
    sums = [d.sum(dim=1, dtype=torch.int32) for d in (a_hi, a_c, bt_hi, bt_c)]
    return (hh, hc, ch, cc, *sums), k_pad


def qmatmul_i64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 product of two int16 matrices, on their device."""
    parts, k_pad = qmatmul_partials(a, b)
    hh, hc, ch, cc, rs_h, rs_c, cs_h, cs_c = (p.to(torch.int64)
                                              for p in parts)
    out = hh * (1 << 16) + (hc + ch) * (1 << 8) + cc
    out += (rs_h * (1 << 15) + rs_c * (1 << 7))[:, None]
    out += (cs_h * (1 << 15) + cs_c * (1 << 7))[None, :]
    return out + k_pad * (1 << 14)


qmatmul_digits.launches = 0
