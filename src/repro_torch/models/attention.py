"""Attention: grouped-query (GQA), MLA (DeepSeek-V2), cross-attention.

The reference's `repro.models.attention` on torch tensors.  Grouped
einsums keep the repeated-KV heads implicit (no materialized repeat);
the decode path consumes a (B, S_max, KV, Dh) cache and returns an
updated copy (the reference's functional ``dynamic_update_slice``).
Masks use the finite ``NEG_INF``, so a fully masked row stays finite.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, dh)
    if kv_override is None:
        k = (x @ params["wk"].to(x.dtype)).reshape(b, s, kv, dh)
        v = (x @ params["wv"].to(x.dtype)).reshape(b, s, kv, dh)
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
    scores = _gqa_scores(q, k, cfg)
    t = k.shape[1]
    if mask is None and cfg.causal and kv_override is None:
        mask = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                     device=x.device))
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores, NEG_INF)
    out = _gqa_out(_softmax(scores, x.dtype), v)
    return out @ params["wo"].to(x.dtype), (k, v)


def _put(cache, new, pos: int):
    """Copy of ``cache`` (B, S_max, ...) with position ``pos`` set."""
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
    q = (x @ params["wq"].to(x.dtype)).reshape(b, 1, h, dh)
    k_new = (x @ params["wk"].to(x.dtype)).reshape(b, 1, kv, dh)
    v_new = (x @ params["wv"].to(x.dtype)).reshape(b, 1, kv, dh)
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
    scores = _gqa_scores(q, cache_k.to(x.dtype), cfg)
    t = cache_k.shape[1]
    valid = (torch.arange(t, device=x.device) <= pos)[None, None, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    out = _gqa_out(_softmax(scores, x.dtype), cache_v.to(x.dtype))
    return out @ params["wo"].to(x.dtype), cache_k, cache_v


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
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c_kv = rms_norm(x @ params["wdkv"].to(x.dtype), params["ckv_norm"])
    k_pe = apply_rope((x @ params["wkpe"].to(x.dtype))[:, :, None, :],
                      positions, cfg.rope_theta)          # (B,S,1,dr)
    k_nope = (c_kv @ params["wuk"].to(x.dtype)).reshape(b, s, h, dn)
    v = (c_kv @ params["wuv"].to(x.dtype)).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_pe.expand(b, s, h, dr)], -1)
    q_full = torch.cat([q_nope, q_pe], -1)
    scores = torch.einsum("bshd,bthd->bhst", q_full, k) / np.sqrt(dn + dr)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = _softmax(scores, x.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h * dv)
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
    q = (x @ params["wq"].to(x.dtype)).reshape(b, 1, h, dn + dr)
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
