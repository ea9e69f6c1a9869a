"""Attention: grouped-query (GQA), MLA (DeepSeek-V2), cross-attention.

The reference's `repro.models.attention` on torch tensors.  Grouped
einsums keep the repeated-KV heads implicit (no materialized repeat);
the decode path consumes a (B, S_max, KV, Dh) cache and returns an
updated copy (the reference's functional ``dynamic_update_slice``).
Masks use the finite ``NEG_INF``, so a fully masked row stays finite.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import hints
from repro_torch.distributed.sharding import P, placements
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       device_of, init_rms, rms_norm)

NEG_INF = -1e9


def init_attention(gen, cfg: ModelConfig) -> Dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * dh)),
        "wk": dense_init(gen, (d, kv * dh)),
        "wv": dense_init(gen, (d, kv * dh)),
        "wo": dense_init(gen, (h * dh, d)),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms(dh, device_of(gen))
        p["k_norm"] = init_rms(dh, device_of(gen))
    return p


def split_heads(t, *shape):
    """(B, S, n * d) -> (B, S, n, d).  On a mesh the model axis first
    shards whole heads or none (a head split by the reshape would be a
    strided shard that later products cannot take)."""
    if isinstance(t, DTensor):
        whole = shape[2] % hints.axis_size("MODEL") == 0
        t = hints.constrain(t, ("BATCH", None, "MODEL" if whole else None))
    return t.reshape(*shape)


def _gqa_scores(q, k, cfg: ModelConfig):
    """q: (B,S,H,Dh), k: (B,T,KV,Dh) -> scores (B,KV,G,S,T) without repeat."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh)
    return torch.einsum("bskgd,btkd->bkgst", qg, k) / np.sqrt(dh)


def _gqa_out(scores, v):
    """scores (B,KV,G,S,T), v (B,T,KV,Dh) -> (B,S,KV*G*Dh)."""
    b, kv, g, s, t = scores.shape
    out = torch.einsum("bkgst,btkd->bskgd", scores, v)
    return out.reshape(b, s, kv * g * v.shape[-1])


def _softmax(scores, dtype):
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def head_parallel(core, q, k, v, replicate: bool = False):
    """``core(q, k, v)`` with q (B, S, H, D), k / v (B, T, KV, D) and a
    result whose dim 2 runs over the heads.  Plain tensors go straight
    to ``core``.  On DTensors each device runs ``core`` (`local_map`) on
    its shard of the batch (the ambient batch axes) and of the heads
    (the model axis), the placement XLA's propagation finds for the
    reference and DTensor's does not (a head-sharded GQA reshape
    becomes a strided shard that ``bmm`` cannot take):

    * H and KV divide the model axis: q, k and v are sharded by head;
    * H divides it and KV does not: q is sharded by head, k and v are
      replicated over the model axis, and each device keeps the kv
      heads of its own q heads (their gradients are partial sums);
    * otherwise, or with ``replicate``, the heads are replicated over
      the model axis (the reference's "on" anchor when kv does not
      divide it).
    """
    if not isinstance(q, DTensor):
        return core(q, k, v)
    mesh = q.device_mesh
    model = hints.model_axis()
    msize = hints.axis_size("MODEL")
    h, kvh = q.shape[2], k.shape[2]
    bax = hints.resolve(q.shape, ("BATCH",))[0]
    q_on = model is not None and not replicate and h % msize == 0
    kv_on = q_on and kvh % msize == 0
    pq = placements(mesh, P(bax, None, model if q_on else None))
    pkv = placements(mesh, P(bax, None, model if kv_on else None))
    gkv = pkv
    local = core
    if q_on and not kv_on:
        mdim = mesh.mesh_dim_names.index(model)
        gkv = tuple(Partial() if i == mdim else p for i, p in enumerate(pkv))
        hl = h // msize
        first = mesh.get_local_rank(model) * hl
        idx = torch.div(torch.arange(first, first + hl), h // kvh,
                        rounding_mode="floor")

        def local(ql, kl, vl):
            sel = idx.to(kl.device)
            return core(ql, kl[:, :, sel], vl[:, :, sel])
    fn = local_map(local, out_placements=list(pq),
                   in_placements=(pq, pkv, pkv),
                   in_grad_placements=(pq, gkv, gkv), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v)


def _gqa_core(q, k, v, mask, dtype, cfg: ModelConfig):
    scores = _gqa_scores(q, k, cfg)
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    return _gqa_out(_softmax(scores, dtype), v)


def attention(params: Dict, x, cfg: ModelConfig, positions,
              mask: Optional[torch.Tensor] = None,
              positions3: Optional[torch.Tensor] = None,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Full-sequence attention (training / prefill).

    mask: (S, T) boolean (True = attend) or None for causal-by-default
    when cfg.causal; kv_override supplies cross-attention keys/values.
    """
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ params["wq"].to(x.dtype), b, s, h, dh)
    if kv_override is None:
        k = split_heads(x @ params["wk"].to(x.dtype), b, s, kv, dh)
        v = split_heads(x @ params["wv"].to(x.dtype), b, s, kv, dh)
    else:
        k, v = kv_override
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"]) if kv_override is None else k
    if kv_override is None:
        if cfg.mrope_sections:
            q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions3, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    t = k.shape[1]
    if mask is None and cfg.causal and kv_override is None:
        mask = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                     device=x.device))
    out = head_parallel(functools.partial(_gqa_core, mask=mask,
                                          dtype=x.dtype, cfg=cfg), q, k, v)
    return out @ params["wo"].to(x.dtype), (k, v)


def _put(cache, new, pos: int):
    """Copy of ``cache`` (B, S_max, ...) with position ``pos`` set."""
    if isinstance(cache, DTensor):
        new = new.redistribute(cache.device_mesh, cache.placements)
    out = cache.clone()
    out[:, pos:pos + 1] = new.to(cache.dtype)
    return out


def decode_attention(params: Dict, x, cfg: ModelConfig, cache_k, cache_v,
                     pos, positions3=None):
    """Single-token decode: x (B,1,d); cache (B,S_max,KV,Dh); pos scalar.

    Returns (out, new_cache_k, new_cache_v)."""
    b, _, d = x.shape
    pos = int(pos)
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(x @ params["wq"].to(x.dtype), b, 1, h, dh)
    k_new = split_heads(x @ params["wk"].to(x.dtype), b, 1, kv, dh)
    v_new = split_heads(x @ params["wv"].to(x.dtype), b, 1, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k_new = rms_norm(k_new, params["k_norm"])
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope_sections:
        q = apply_mrope(q, positions3, cfg.rope_theta, cfg.mrope_sections)
        k_new = apply_mrope(k_new, positions3, cfg.rope_theta,
                            cfg.mrope_sections)
    else:
        q = apply_rope(q, posb, cfg.rope_theta)
        k_new = apply_rope(k_new, posb, cfg.rope_theta)
    cache_k = _put(cache_k, k_new, pos)
    cache_v = _put(cache_v, v_new, pos)
    t = cache_k.shape[1]
    valid = (torch.arange(t, device=x.device) <= pos)[None]
    ck, cv = cache_k.to(x.dtype), cache_v.to(x.dtype)
    if _dh_sharded(ck):
        out = _decode_dh_parallel(q, ck, cv, valid, x.dtype, cfg)
    else:
        out = head_parallel(functools.partial(_gqa_core, mask=valid,
                                              dtype=x.dtype, cfg=cfg),
                            q, ck, cv)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v


def _dh_sharded(cache) -> bool:
    """A DTensor cache (B, T, KV, Dh) whose Dh is sharded over the model
    axis (the reference's cache layout when KV does not divide it)."""
    if not isinstance(cache, DTensor) or hints.model_axis() is None:
        return False
    mdim = cache.device_mesh.mesh_dim_names.index(hints.model_axis())
    return cache.placements[mdim] == Shard(3)


def _decode_dh_parallel(q, ck, cv, valid, dtype, cfg: ModelConfig):
    """Decode attention against a cache sharded over Dh on the model
    axis: each device takes the partial scores of its Dh slice, their
    sum over the axis feeds the softmax, and each device's share of the
    output is its Dh slice, gathered before the output projection.  The
    cache is never gathered."""
    mesh = q.device_mesh
    b, s, h, dh = q.shape
    bax = hints.resolve(q.shape, ("BATCH",))[0]
    model = hints.model_axis()
    mdim = mesh.mesh_dim_names.index(model)
    p_dh = placements(mesh, P(bax, None, None, model))
    p_sc = tuple(Partial() if i == mdim else pl for i, pl in
                 enumerate(placements(mesh, P(bax))))

    def partial_scores(ql, kl):
        kv = kl.shape[2]
        qg = ql.reshape(ql.shape[0], s, kv, h // kv, ql.shape[-1])
        return torch.einsum("bskgd,btkd->bkgst", qg, kl) / np.sqrt(dh)
    scores = local_map(partial_scores, out_placements=list(p_sc),
                       in_placements=(p_dh, p_dh), device_mesh=mesh,
                       redistribute_inputs=True)(q, ck)
    scores = scores.redistribute(mesh, placements(mesh, P(bax)))  # the sum
    scores = torch.where(valid[None, None, None], scores, NEG_INF)
    probs = _softmax(scores, dtype)

    def out_slice(pl, vl):
        out = torch.einsum("bkgst,btkd->bskgd", pl, vl)
        return out.reshape(out.shape[0], s, h, vl.shape[-1])
    out = local_map(out_slice, out_placements=list(p_dh),
                    in_placements=(placements(mesh, P(bax)), p_dh),
                    device_mesh=mesh, redistribute_inputs=True)(probs, cv)
    out = hints.constrain(out, ("BATCH", None, None, None))
    return out.reshape(b, s, h * dh)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2).  The KV cache stores only
# the compressed c_kv (kv_lora_rank) + the shared RoPE key (qk_rope_dim).
# ---------------------------------------------------------------------------

def init_mla(gen, cfg: ModelConfig) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    return {
        "wq": dense_init(gen, (d, h * (dn + dr))),
        "wdkv": dense_init(gen, (d, r)),
        "wkpe": dense_init(gen, (d, dr)),
        "wuk": dense_init(gen, (r, h * dn)),
        "wuv": dense_init(gen, (r, h * dv)),
        "wo": dense_init(gen, (h * dv, d)),
        "ckv_norm": init_rms(r, device_of(gen)),
    }


def mla_attention(params: Dict, x, cfg: ModelConfig, positions):
    b, s, d = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = split_heads(x @ params["wq"].to(x.dtype), b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c_kv = rms_norm(x @ params["wdkv"].to(x.dtype), params["ckv_norm"])
    k_pe = apply_rope((x @ params["wkpe"].to(x.dtype))[:, :, None, :],
                      positions, cfg.rope_theta)          # (B,S,1,dr)
    k_nope = split_heads(c_kv @ params["wuk"].to(x.dtype), b, s, h, dn)
    v = split_heads(c_kv @ params["wuv"].to(x.dtype), b, s, h, dv)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, dr)], -1)
    q_full = torch.cat([q_nope, q_pe], -1)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))

    def core(q_full, k, v):
        scores = torch.einsum("bshd,bthd->bhst", q_full, k) / np.sqrt(dn + dr)
        scores = torch.where(mask[None, None], scores, NEG_INF)
        probs = _softmax(scores, x.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, v)
        return out.reshape(out.shape[0], s, -1)

    out = head_parallel(core, q_full, k, v)
    return out @ params["wo"].to(x.dtype), (c_kv, k_pe[:, :, 0, :])


def mla_decode(params: Dict, x, cfg: ModelConfig, cache_ckv, cache_kpe, pos,
               absorbed: bool = True):
    """MLA decode against the compressed cache.

    absorbed=True uses the W_uk-absorbed query: attention runs in the
    rank-r latent space, avoiding the per-step re-expansion of K from
    the whole cache.
    """
    b, _, d = x.shape
    pos = int(pos)
    h = cfg.n_heads
    dn, dr, dv, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    q = split_heads(x @ params["wq"].to(x.dtype), b, 1, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_pe = apply_rope(q_pe, posb, cfg.rope_theta)
    c_new = rms_norm(x @ params["wdkv"].to(x.dtype), params["ckv_norm"])
    kpe_new = apply_rope((x @ params["wkpe"].to(x.dtype))[:, :, None, :],
                         posb, cfg.rope_theta)[:, :, 0, :]
    cache_ckv = _put(cache_ckv, c_new, pos)
    cache_kpe = _put(cache_kpe, kpe_new, pos)
    t = cache_ckv.shape[1]
    ckv = cache_ckv.to(x.dtype)
    if absorbed:
        wuk = params["wuk"].to(x.dtype).reshape(r, h, dn)
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope, wuk)
        s_nope = torch.einsum("bshr,btr->bhst", q_abs, ckv)
    else:
        k_nope = (ckv @ params["wuk"].to(x.dtype)).reshape(b, t, h, dn)
        s_nope = torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
    s_pe = torch.einsum("bshd,btd->bhst", q_pe, cache_kpe.to(x.dtype))
    scores = (s_nope + s_pe) / np.sqrt(dn + dr)
    valid = (torch.arange(t, device=x.device) <= pos)[None, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    probs = _softmax(scores, x.dtype)
    if absorbed:
        lat = torch.einsum("bhst,btr->bshr", probs, ckv)
        wuv = params["wuv"].to(x.dtype).reshape(r, h, dv)
        out = torch.einsum("bshr,rhd->bshd", lat, wuv).reshape(b, 1, h * dv)
    else:
        v = (ckv @ params["wuv"].to(x.dtype)).reshape(b, t, h, dv)
        out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, 1, h * dv)
    return out @ params["wo"].to(x.dtype), cache_ckv, cache_kpe
