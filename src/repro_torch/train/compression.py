"""Gradient compression with error feedback (the reference's
`repro.train.compression`).

int8 block quantization halves the bytes a data-parallel all-reduce
moves, top-k sparsification cuts them by about k; both are modelled as
a round trip (compress, then decompress) before the optimizer, which
is what the wire sees.  Error feedback keeps the residual
(g - dequant(quant(g))) and adds it back the next step, restoring
convergence to the uncompressed fixed point (Karimireddy et al. 2019).
On one device nothing crosses a wire: the round trip keeps the
reference's numerics.  On a device mesh a DTensor gradient and its
residual are replicated first and every device runs the round trip on
the whole tensor, so the blocks and the top-k run over the whole
flattened tensor as on one device (the residual is re-sharded with the
state).  DTensor's own flatten of a tensor sharded past dim 0 gives a
strided shard, over which the block reshape went wrong.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"           # none | int8 | topk
    block: int = 256             # int8: scale-block length
    topk_frac: float = 0.01      # topk: fraction of entries kept
    error_feedback: bool = True


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _int8_quant(g, block: int):
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def _int8_dequant(q, scale, pad: int, shape):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _topk_mask(g, frac: float):
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.sort(torch.abs(flat)).values[-k]
    return (torch.abs(g) >= thresh).to(g.dtype)


@torch.no_grad()
def compress_grads(cfg: CompressionConfig, grads, residuals):
    """Returns (compressed-then-decompressed grads, new residuals)."""
    if cfg.mode == "none":
        return grads, residuals

    def one(g, r):
        g32 = g.float()
        if cfg.error_feedback:
            g32 = g32 + r
        if cfg.mode == "int8":
            q, scale, pad = _int8_quant(g32, cfg.block)
            out = _int8_dequant(q, scale, pad, g32.shape)
        elif cfg.mode == "topk":
            out = g32 * _topk_mask(g32, cfg.topk_frac)
        else:
            raise ValueError(cfg.mode)
        new_r = (g32 - out) if cfg.error_feedback else r
        return out.to(g.dtype), new_r

    def replicated(g, r):
        # the whole tensor on every device, the same round trip on each
        mesh, rep = g.device_mesh, [Replicate()] * g.device_mesh.ndim
        out, new_r = one(g.redistribute(mesh, rep).to_local(),
                         r.redistribute(mesh, rep).to_local())
        return (DTensor.from_local(out, mesh, rep, run_check=False),
                DTensor.from_local(new_r, mesh, rep, run_check=False))

    outs = [(replicated if isinstance(g, DTensor) else one)(g, r)
            for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def wire_bytes_per_param(cfg: CompressionConfig) -> float:
    """Analytic bytes/param crossing the data axis (for the roofline)."""
    if cfg.mode == "int8":
        return 1.0 + 4.0 / cfg.block
    if cfg.mode == "topk":
        return cfg.topk_frac * 8.0       # value + index
    return 2.0                           # bf16
