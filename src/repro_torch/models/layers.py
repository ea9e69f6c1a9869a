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
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import hints
from repro_torch.distributed.sharding import P, placements


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


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On DTensors each device looks up the rows of
    its own vocab range for its own batch shard (a partial sum over the
    model axis when the vocab is sharded there), which the residual
    stream's placement then reduces."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    model = hints.model_axis()
    v_axis = None
    if model is not None:
        mdim = mesh.mesh_dim_names.index(model)
        if table.placements[mdim] == Shard(0):
            v_axis = model
    bax = hints.resolve(tokens.shape, ("BATCH",))[0]
    p_tok = placements(mesh, P(bax))
    p_out = placements(mesh, P(bax))
    g_tab = placements(mesh, P(v_axis))
    g_tab = tuple(Partial() if name in (bax or ()) else pl
                  for name, pl in zip(mesh.mesh_dim_names, g_tab))
    if v_axis is not None:
        p_out = tuple(Partial() if i == mdim else pl
                      for i, pl in enumerate(p_out))
        v_loc = table.shape[0] // hints.axis_size("MODEL")
        first = mesh.get_local_rank(model) * v_loc
    else:
        v_loc, first = table.shape[0], 0

    def lookup(tab, tok):
        if v_axis is None:
            return tab[tok.long()]
        t = tok.long() - first
        inside = (t >= 0) & (t < v_loc)
        rows = tab[torch.clamp(t, 0, v_loc - 1)]
        return torch.where(inside[..., None], rows, 0)
    return local_map(lookup, out_placements=list(p_out),
                     in_placements=(placements(mesh, P(v_axis)), p_tok),
                     in_grad_placements=(g_tab, p_tok), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean CE over tokens; logits (..., V) any float dtype."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        return torch.mean(_token_nll_vocab_parallel(logits, labels))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


def _token_nll_vocab_parallel(logits: DTensor, labels) -> DTensor:
    """Per-token -log p(label) of DTensor logits (B, S, V), sharded over
    the batch axes.  With the vocab replicated over the model axis each
    device runs the plain formula on its tokens; with the vocab sharded
    there, `_VocabShardedNLL`."""
    mesh = logits.device_mesh
    model = hints.model_axis()
    bax = hints.resolve(logits.shape, ("BATCH",))[0]
    p_tok = placements(mesh, P(bax, None))
    if model is not None:
        mdim = mesh.mesh_dim_names.index(model)
        if logits.placements[mdim] == Shard(logits.ndim - 1):
            return _VocabShardedNLL.apply(logits, labels, bax, model)

    def nll(lg, lb):
        lse = torch.logsumexp(lg, dim=-1)
        return lse - torch.gather(lg, -1, lb[..., None].long())[..., 0]
    p_in = placements(mesh, P(bax, None, None))
    return local_map(nll, out_placements=list(p_tok),
                     in_placements=(p_in, p_tok), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def _label_mask(logits: DTensor, labels, bax, model) -> DTensor:
    """One-hot of the labels (B, S, V) in the logits' float dtype, each
    device's vocab shard filled from its own range."""
    mesh = logits.device_mesh
    v_loc = logits.shape[-1] // hints.axis_size("MODEL")
    first = mesh.get_local_rank(model) * v_loc
    p_lg = placements(mesh, P(bax, None, model))

    def onehot(lb):
        t = lb.long() - first
        cols = torch.arange(v_loc, device=lb.device)
        return (t[..., None] == cols).to(logits.dtype)
    return local_map(onehot, out_placements=list(p_lg),
                     in_placements=(placements(mesh, P(bax, None)),),
                     device_mesh=mesh, redistribute_inputs=True)(labels)


class _VocabShardedNLL(torch.autograd.Function):
    """-log softmax(logits)[label] with the vocab sharded over the model
    axis (Megatron's vocab-parallel cross entropy): the max and the sum
    of exponentials are reduced over the axis, and the gradient
    softmax - one-hot is formed on each device's own vocab shard, so no
    device ever holds the whole vocab (DTensor's own choice for the
    backward of the reductions gathers it)."""

    @staticmethod
    def forward(ctx, logits, labels, bax, model):
        mesh = logits.device_mesh
        p_tok = placements(mesh, P(bax, None))
        p_keep = placements(mesh, P(bax, None, None))
        m = torch.amax(logits, dim=-1, keepdim=True).redistribute(
            mesh, p_keep)                               # the max over V
        se = torch.sum(torch.exp(logits - m), dim=-1).redistribute(
            mesh, p_tok)                                # the sum over V
        lse = torch.log(se) + m[..., 0]
        ll = torch.sum(logits * _label_mask(logits, labels, bax, model),
                       dim=-1).redistribute(mesh, p_tok)
        ctx.save_for_backward(logits, lse, labels)
        ctx.bax, ctx.model = bax, model
        return lse - ll

    @staticmethod
    def backward(ctx, grad):
        logits, lse, labels = ctx.saved_tensors
        mesh = logits.device_mesh
        grad = grad.redistribute(mesh, placements(mesh, P(ctx.bax, None)))
        probs = torch.exp(logits - lse[..., None])
        probs = probs - _label_mask(logits, labels, ctx.bax, ctx.model)
        return probs * grad[..., None], None, None, None
