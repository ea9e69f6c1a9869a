"""Layout + wrapper of the zkReLU validity-table kernel
(`validity_tables.cu`) and its plain version.

`build_layout` flattens the stacked aux tensors into per-(row, bit)
int32 position planes on their own device (the same planes as the
reference's numpy `build_layout`); `build_tables` evaluates the eq. (19)
``a`` / ``b`` vectors of BOTH validity statements (main Q-bit, then
remainder R-bit) in one launch.  CPU tensors take the plain version;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.field.modarith import (FQ, add, encode_int,
                                        mont_mul_plain, sub)
from repro_torch.kernels import _build
from repro_torch.kernels.modmul.ops import _check_cuda


@dataclasses.dataclass(frozen=True)
class ValidityLayout:
    """Flat per-(row, bit) position planes, main statement then
    remainder (all (n,) int32, n = 2 Ds (Q + R)):

    ``vals``     the packed source value whose bit this position holds
                 (two's-complement for the signed G_A' half)
    ``shift``    the bit index within ``vals``
    ``kmask``    B_{Q-1}[row] at the forced (top-half, col Q-1) slots
    ``kpmask``   1 - B_{Q-1}[row] there
    ``colmask``  1 at the forced column (the B' forced-zero column)
    ``region``   1 on the main statement, 0 on the remainder
    """
    vals: torch.Tensor
    shift: torch.Tensor
    kmask: torch.Tensor
    kpmask: torch.Tensor
    colmask: torch.Tensor
    region: torch.Tensor
    n_main: int
    n_rem: int


def build_layout(zpp, gap, bq, rz, rga, q_bits: int,
                 r_bits: int) -> ValidityLayout:
    """Stacked aux value vectors (int64 tensors) -> flat kernel layout."""
    ds = zpp.shape[0]
    qb, rb = q_bits, r_bits
    dev = zpp.device
    assert qb < 32 and rb < 32, "values must fit 32 bits"
    lim = 1 << (qb - 1)
    assert bool(((zpp >= 0) & (zpp < lim)).all())
    assert bool(((gap >= -lim) & (gap < lim)).all())
    gap_u = torch.where(gap < 0, gap + (1 << qb), gap)
    u_main = torch.cat([zpp, gap_u]).to(torch.int32)          # (2ds,)
    u_rem = torch.cat([rz, rga]).to(torch.int32)
    n_main, n_rem = 2 * ds * qb, 2 * ds * rb
    i32 = dict(dtype=torch.int32, device=dev)
    vals = torch.cat([torch.repeat_interleave(u_main, qb),
                      torch.repeat_interleave(u_rem, rb)])
    shift = torch.cat([torch.arange(qb, **i32).repeat(2 * ds),
                       torch.arange(rb, **i32).repeat(2 * ds)])
    # the forced column (top-half rows, bit Q-1): B is 0 there by range
    # (zpp < 2^{Q-1}), B' is forced to 0, and the k-term adds B_{Q-1}
    bq32 = bq.to(torch.int32)
    kmask = torch.zeros((2 * ds, qb), **i32)
    kmask[:ds, qb - 1] = bq32
    kpmask = torch.zeros((2 * ds, qb), **i32)
    kpmask[:ds, qb - 1] = 1 - bq32
    colmask = torch.zeros((2 * ds, qb), **i32)
    colmask[:ds, qb - 1] = 1
    zpad = torch.zeros(n_rem, **i32)
    region = torch.cat([torch.ones(n_main, **i32), zpad])
    return ValidityLayout(
        vals=vals, shift=shift,
        kmask=torch.cat([kmask.reshape(-1), zpad]),
        kpmask=torch.cat([kpmask.reshape(-1), zpad]),
        colmask=torch.cat([colmask.reshape(-1), zpad]),
        region=region, n_main=n_main, n_rem=n_rem)


def _scalars(k: int, z_main: int, z_rem: int):
    return (FQ.one, encode_int(FQ, k), encode_int(FQ, z_main),
            encode_int(FQ, z_rem))


def build_tables_plain(layout: ValidityLayout, k: int, z_main: int,
                       z_rem: int, e_full: torch.Tensor, es: torch.Tensor):
    one, k_m, zm, zr = _scalars(k, z_main, z_rem)
    zero = torch.zeros_like(e_full)
    bit = (layout.vals >> layout.shift) & 1

    def sel(mask01, scalar):
        return torch.where(mask01 != 0, zero + scalar, zero)

    zsel = torch.where(layout.region != 0, zero + zm, zero + zr)
    a = sub(FQ, add(FQ, sel(bit, one), sel(layout.kmask, k_m)), zsel)
    negbp = add(FQ, sel((1 - bit) * (1 - layout.colmask), one),
                sel(layout.kpmask, k_m))
    b = add(FQ, es, mont_mul_plain(FQ, sub(FQ, zsel, negbp), e_full))
    return a, b


def build_tables(layout: ValidityLayout, k: int, z_main: int, z_rem: int,
                 e_full: torch.Tensor, es: torch.Tensor):
    """Layout + challenges + (n,) Montgomery e-tables -> (a, b), two (n,)
    Montgomery tables covering both statements (split at
    ``layout.n_main``)."""
    n = layout.vals.shape[0]
    assert e_full.shape == (n,) and es.shape == (n,)
    if e_full.device.type == "cpu":
        return build_tables_plain(layout, k, z_main, z_rem, e_full, es)
    _check_cuda(e_full, "validity_tables")
    _check_cuda(es, "validity_tables")
    planes = [p.contiguous() for p in (layout.vals, layout.shift,
                                       layout.kmask, layout.kpmask,
                                       layout.colmask, layout.region)]
    for p in planes:
        if p.dtype != torch.int32 or p.device != e_full.device:
            raise TypeError("validity_tables: layout planes must be int32 "
                            "on the tables' device")
    e_full, es = e_full.contiguous(), es.contiguous()
    a = torch.empty_like(e_full)
    b = torch.empty_like(e_full)
    one, k_m, zm, zr = _scalars(k, z_main, z_rem)
    err = _build.lib("validity_tables").zk_validity_tables(
        *[p.data_ptr() for p in planes], e_full.data_ptr(), es.data_ptr(),
        a.data_ptr(), b.data_ptr(), n, one, k_m, zm, zr, FQ.modulus,
        FQ.nprime64, _build.stream_handle(e_full.device))
    _build.check(err, "validity_tables")
    build_tables.launches += 1
    return a, b


build_tables.launches = 0
