"""Shared neural layers: norms, rotary embeddings, MLPs (pure functional).

The reference's `repro.models.layers` on torch tensors.  Parameters are
float32 masters; every product casts its weight to the activation's
dtype first, as the reference does, and norms, softmax and the loss run
in float32.  Random init draws the reference's distributions from an
explicit `torch.Generator` (JAX's key streams cannot be reproduced).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * weight.float()
    return out.to(dt)


def init_rms(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def device_of(gen) -> torch.device:
    """Where a parameter draw lands: a generator's device, or ``meta``
    when ``gen`` is the meta device (shapes only: `steps.state_specs`)."""
    return gen if isinstance(gen, torch.device) else gen.device


def _draw(fn, gen, shape) -> torch.Tensor:
    if isinstance(gen, torch.device):
        assert gen.type == "meta", "parameters are drawn from a Generator"
        return torch.empty(tuple(shape), dtype=torch.float32, device=gen)
    return fn(tuple(shape), generator=gen, dtype=torch.float32,
              device=gen.device)


def dense_init(gen, shape, in_axis: int = 0) -> torch.Tensor:
    """Uniform in +-1/sqrt(fan_in), on the generator's device."""
    scale = 1.0 / np.sqrt(shape[in_axis])
    return _draw(torch.rand, gen, shape) * (2 * scale) - scale


def normal_init(gen, shape, std: float) -> torch.Tensor:
    return _draw(torch.randn, gen, shape) * std


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x, ang):
    """x (..., Dh) rotated by angles (B, S, half) broadcast over heads;
    the product runs in float32 and is cast back to x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    ang = positions[..., None].float() * freqs                   # (B,S,half)
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions3 (3, B, S); the rotary half-dim
    is split into `sections` (t, h, w), each using its own position stream."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec_id = torch.as_tensor(np.repeat(np.arange(len(sections)), sections),
                             device=x.device)
    pos = positions3[sec_id]                                     # (half,B,S)
    ang = pos.permute(1, 2, 0).float() * freqs
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU-style; act configurable so ReLU nets are zkReLU-provable)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> Dict:
    return {
        "wi": dense_init(gen, (d_model, d_ff)),
        "wg": dense_init(gen, (d_model, d_ff)),
        "wo": dense_init(gen, (d_ff, d_model)),
    }


def mlp(params: Dict, x: torch.Tensor, act_name: str) -> torch.Tensor:
    act = activation(act_name)
    h = act(x @ params["wg"].to(x.dtype)) * (x @ params["wi"].to(x.dtype))
    return h @ params["wo"].to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean CE over tokens; logits (..., V) any float dtype."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)
