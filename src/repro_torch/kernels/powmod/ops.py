"""Wrapper of the powmod kernel (`powmod.cu`) and its plain version.

`powmod` is what `repro_torch.core.group.g_pow` and
`repro_torch.field.modarith.pow_const` call: elementwise powers of
Montgomery-form words over any `FieldSpec`.  An exponent is either an
int64 tensor of standard-form words, broadcast against the bases, of
which the low ``nbits`` bits are used, or a python int in [0, 2^64),
used whole and passed to the kernel by value.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel, or raises -- there is
no fallback.  A one-element base or exponent tensor is read with stride
0; any other broadcast is materialised first.
"""
from __future__ import annotations

import torch

from repro_torch.field.modarith import MASK64, FieldSpec, mont_mul
from repro_torch.kernels import _build
from repro_torch.kernels.modmul.ops import _check_cuda


def _check(bases: torch.Tensor, exps, nbits: int) -> None:
    if bases.dtype != torch.int64:
        raise TypeError(f"powmod: expected int64 bases, got {bases.dtype}")
    if not 1 <= nbits <= 63:
        raise ValueError(f"powmod: nbits {nbits} is not in [1, 63]")
    if isinstance(exps, torch.Tensor):
        if exps.dtype != torch.int64:
            raise TypeError(f"powmod: expected int64 exponents, got "
                            f"{exps.dtype}")
        try:
            torch.broadcast_shapes(bases.shape, exps.shape)
        except RuntimeError as exc:
            raise ValueError(f"powmod: bases {tuple(bases.shape)} and "
                             f"exponents {tuple(exps.shape)} do not "
                             "broadcast") from exc
    elif not 0 <= int(exps) <= MASK64:
        raise ValueError(f"powmod: exponent {int(exps)} is not in "
                         "[0, 2^64)")


def powmod_plain(spec: FieldSpec, bases: torch.Tensor, exps,
                 nbits: int = 63) -> torch.Tensor:
    """`powmod` in torch ops: for a python-int exponent, square and
    multiply over its bits on the host; for an exponent tensor, one
    conditional multiply and one squaring of the whole vector a bit, up to
    the highest bit any exponent sets."""
    if not isinstance(exps, torch.Tensor):
        e = int(exps)
        if e == 0:
            return torch.full_like(bases, spec.one)
        result = None
        base = bases
        while e:
            if e & 1:
                result = base if result is None else mont_mul(spec, result,
                                                              base)
            e >>= 1
            if e:
                base = mont_mul(spec, base, base)
        return result
    shape = torch.broadcast_shapes(bases.shape, exps.shape)
    acc = bases.expand(shape).contiguous()
    exps = exps.expand(shape)
    res = torch.full(shape, spec.one, dtype=torch.int64, device=bases.device)
    if exps.numel() == 0:
        return res
    top = min(nbits, int(exps.max()).bit_length())
    for j in range(top):
        bit = ((exps >> j) & 1) != 0
        res = torch.where(bit, mont_mul(spec, res, acc), res)
        if j + 1 < top:
            acc = mont_mul(spec, acc, acc)
    return res


def _stride(t: torch.Tensor, shape: torch.Size):
    """(tensor, stride) for the kernel: a tensor of the broadcast's size
    as it lies, one element with stride 0, anything else materialised."""
    if t.numel() == shape.numel():
        return t.contiguous(), 1
    if t.numel() == 1:
        return t.contiguous(), 0
    return t.expand(shape).contiguous(), 1


def powmod(spec: FieldSpec, bases: torch.Tensor, exps,
           nbits: int = 63) -> torch.Tensor:
    """Elementwise bases^exps in Montgomery form (bases canonical words):
    an exponent tensor's low ``nbits`` bits, or a python int whole."""
    _check(bases, exps, nbits)
    if bases.device.type == "cpu":
        return powmod_plain(spec, bases, exps, nbits)
    _check_cuda(bases, "powmod")
    if spec.modulus >= 1 << 62:         # the kernel's lazy REDC bound
        raise ValueError(f"powmod: modulus of {spec.name} is not below 2^62")
    if isinstance(exps, torch.Tensor):
        _check_cuda(exps, "powmod")
        shape = torch.broadcast_shapes(bases.shape, exps.shape)
        (base, base_inc), (exp, exp_inc) = (_stride(bases, shape),
                                            _stride(exps, shape))
        exp_ptr, value, mask = exp.data_ptr(), 0, (1 << nbits) - 1
    else:
        shape, (base, base_inc) = bases.shape, (bases.contiguous(), 1)
        exp_ptr, exp_inc, value, mask = None, 0, int(exps), MASK64
    out = torch.empty(shape, dtype=torch.int64, device=bases.device)
    err = _build.lib("powmod").zk_powmod(
        base.data_ptr(), base_inc, exp_ptr, exp_inc, value, mask,
        out.data_ptr(), out.numel(), spec.one, spec.modulus, spec.nprime64,
        _build.stream_handle(bases.device))
    _build.check(err, "powmod")
    powmod.launches += 1
    return out


powmod.launches = 0
