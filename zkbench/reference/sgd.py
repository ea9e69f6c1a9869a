"""The quantised FCNN's integer SGD step (zkDL Example 4.5) in plain
PyTorch.

Values are fixed-point integers at scale 2^R in int64 tensors:

    Z^l   = A^{l-1} W^l,  Z'^l = floor(Z^l / 2^R),  R_Z = Z^l - 2^R Z'^l
    B^l   = [Z'^l < 0],   Z''^l = Z'^l + 2^{Q-1} B^l,  A^l = (1 - B^l) Z''^l
    G_Z^L = Z'^L - Y
    G_A^l = G_Z^{l+1} W^{l+1,T},  G_A'^l = floor(G_A^l / 2^R),  R_GA = ...
    G_Z^l = (1 - B^l) G_A'^l,     G_W^l = G_Z^{l,T} A^{l-1}
    W^l  <- clamp(W^l - floor(G_W^{l,T} / 2^{lr_shift + R}), Q-bit range)

Every product is exact: float64 holds every integer below 2^53, and
`exact_matmul` checks that no partial sum can reach it.  `int8_matmul`
is the control: the same products with each operand rounded to int8
under a power-of-two scale, the precision below the configuration's
16-bit one.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

EXACT_LIMIT = 1 << 53


def _max_abs(t: torch.Tensor) -> int:
    return int(t.abs().max()) if t.numel() else 0


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int64 product of int64 matrices, through float64."""
    if _max_abs(a) * _max_abs(b) * a.shape[1] >= EXACT_LIMIT:
        raise OverflowError("product too wide for an exact float64 sum")
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def _to_int8(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    shift = max(0, _max_abs(t).bit_length() - 7)
    q = torch.round(t.to(torch.float64) / (1 << shift)).clamp(-127, 127)
    return q, shift


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control: each operand rounded to int8 with a power-of-two
    scale, the int8 product scaled back."""
    qa, sa = _to_int8(a)
    qb, sb = _to_int8(b)
    return torch.round((qa @ qb) * float(1 << (sa + sb))).to(torch.int64)


def _split(v: torch.Tensor, scale: int, lim: int, what: str):
    vp = torch.div(v, scale, rounding_mode="floor")
    if bool(((vp < -lim) | (vp >= lim)).any()):
        raise OverflowError(f"{what} leaves the Q-bit range")
    return vp, v - vp * scale


def sgd_step(ws: List[torch.Tensor], x: torch.Tensor, y: torch.Tensor,
             q_bits: int, r_bits: int, lr_shift: int,
             matmul: Callable = exact_matmul
             ) -> Tuple[List[torch.Tensor], Dict[str, List[torch.Tensor]]]:
    """One step: the updated weights, and the step's committed aux
    tensors by slot name (zpp, bq, rz per layer; gap, rga per layer but
    the last; gw per layer, (out, in))."""
    scale, lim, L = 1 << r_bits, 1 << (q_bits - 1), len(ws)
    x, y = x.to(torch.int64), y.to(torch.int64)
    a, zpp, bits, rz = [x], [], [], []
    for l in range(L):
        zp, r = _split(matmul(a[l], ws[l]), scale, lim, "Z'")
        b = (zp < 0).to(torch.int64)
        zpp.append(zp + lim * b)
        bits.append(b)
        rz.append(r)
        if l < L - 1:
            a.append((1 - b) * zpp[l])
    gz = [None] * L
    gz[L - 1] = (zpp[L - 1] - lim * bits[L - 1]) - y
    gap, rga = [None] * (L - 1), [None] * (L - 1)
    for m in range(L - 1, 0, -1):
        gap[m - 1], rga[m - 1] = _split(matmul(gz[m], ws[m].T), scale, lim,
                                        "G_A'")
        gz[m - 1] = (1 - bits[m - 1]) * gap[m - 1]
    gw = [matmul(gz[l].T, a[l]) for l in range(L)]
    lr = 1 << (lr_shift + r_bits)
    new = [torch.clamp(w - torch.div(g, lr, rounding_mode="floor").T,
                       -lim, lim - 1) for w, g in zip(ws, gw)]
    return new, {"zpp": zpp, "bq": bits, "rz": rz, "gap": gap, "rga": rga,
                 "gw": gw}
