"""Wrapper of the modmul kernel (`modmul.cu`) and its plain version.

`modmul` is what `repro_torch.field.mont_mul` calls.  A CPU tensor takes
the plain version (`repro_torch.field.modarith.mont_mul_plain`); a CUDA
tensor launches the kernel, or raises -- there is no fallback.  A
python-int operand is passed to the kernel by value; a one-element
tensor operand is read with stride 0; any other broadcast is
materialised first.
"""
from __future__ import annotations

import torch

from repro_torch.field.modarith import FieldSpec, mont_mul_plain
from repro_torch.kernels import _build


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype != torch.int64:
        raise TypeError(f"{what}: expected int64 words, got {t.dtype}")


def modmul_plain(spec: FieldSpec, a: torch.Tensor, b) -> torch.Tensor:
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(int(b), dtype=torch.int64, device=a.device)
    return mont_mul_plain(spec, a, b)


def modmul(spec: FieldSpec, a, b) -> torch.Tensor:
    """Elementwise Montgomery product a * b * 2^-64 mod m (broadcasting)."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if a.device.type == "cpu":
        return modmul_plain(spec, a, b)
    _check_cuda(a, "modmul")
    lib = _build.lib("modmul")
    stream = _build.stream_handle(a.device)
    if not isinstance(b, torch.Tensor):
        a = a.contiguous()
        out = torch.empty_like(a)
        err = lib.zk_modmul_scalar(a.data_ptr(), int(b), out.data_ptr(),
                                   a.numel(), spec.modulus, spec.nprime64,
                                   stream)
        _build.check(err, "modmul")
        modmul.launches += 1
        return out
    _check_cuda(b, "modmul")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    size = shape.numel()
    if b.numel() == 1 and a.numel() == size:
        a_inc, b_inc = 1, 0
    elif a.numel() == 1 and b.numel() == size:
        a_inc, b_inc = 0, 1
    else:
        a, b = a.expand(shape), b.expand(shape)
        a_inc = b_inc = 1
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    err = lib.zk_modmul(a.data_ptr(), a_inc, b.data_ptr(), b_inc,
                        out.data_ptr(), out.numel(), spec.modulus,
                        spec.nprime64, stream)
    _build.check(err, "modmul")
    modmul.launches += 1
    return out


modmul.launches = 0
