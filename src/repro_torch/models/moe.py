"""Mixture-of-experts with sorted capacity dispatch (the reference's
`repro.models.moe`, one-device path).

Tokens-choose-experts top-k routing; assignments are sorted by expert
(a STABLE sort: capacity slots follow token order within an expert) and
scattered into an (E, C, d) buffer, so expert FFN compute scales with
top_k, not E.  Assignments beyond capacity go to one extra overflow row
that is then dropped (capacity_factor controls the head-room).  The
reference's per-shard ``shard_map`` dispatch is mesh code and is not
part of this module.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation, dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, (d, e)),
        "wi": dense_init(gen, (e, d, f), in_axis=1),
        "wg": dense_init(gen, (e, d, f), in_axis=1),
        "wo": dense_init(gen, (e, f, d), in_axis=1),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "wi": dense_init(gen, (d, fs)),
            "wg": dense_init(gen, (d, fs)),
            "wo": dense_init(gen, (fs, d)),
        }
    return p


def _route_and_dispatch(xf, router_w, e: int, k: int, cap: int):
    """Route xf (n, d) -> dispatch buffer (e, cap, d) + combine metadata."""
    n, d = xf.shape
    logits = (xf @ router_w.to(xf.dtype)).float()
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)

    flat_e = idx.reshape(-1)                                   # (n*k,)
    flat_t = torch.arange(n, device=xf.device).repeat_interleave(k)
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    ar = torch.arange(n * k, device=xf.device)
    seg_start = torch.searchsorted(
        se, torch.arange(e, device=xf.device, dtype=se.dtype), side="left")
    pos_in_e = ar - seg_start[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))           # overflow row

    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((slot,), xf[st])
    buf = buf[:-1].reshape(e, cap, d)
    return buf, (st, sg, keep, slot)


def _combine(out_e, meta, n: int, cap: int, dtype):
    """Inverse of dispatch: (e, cap, d) expert outputs -> (n, d) tokens."""
    st, sg, keep, slot = meta
    e_cap = out_e.shape[0] * cap
    out_flat = out_e.reshape(e_cap, -1)
    contrib = torch.where(keep[:, None],
                          out_flat[torch.clamp(slot, 0, e_cap - 1)]
                          * sg[:, None].to(dtype), 0)
    y = torch.zeros((n, out_flat.shape[-1]), dtype=dtype,
                    device=out_e.device)
    return y.index_add(0, st, contrib.to(dtype))


def moe_ffn(params: Dict, x, cfg: ModelConfig):
    """x: (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    cap = int(cfg.capacity_factor * n * k / e)
    cap = max(8, min(cap, n))
    act = activation(cfg.act)
    xf = x.reshape(n, d)

    buf, meta = _route_and_dispatch(xf, params["router"], e, k, cap)
    h = act(torch.bmm(buf, params["wg"].to(x.dtype)))
    h = h * torch.bmm(buf, params["wi"].to(x.dtype))
    out_e = torch.bmm(h, params["wo"].to(x.dtype))
    y = _combine(out_e, meta, n, cap, x.dtype)

    if cfg.n_shared_experts:
        sh = params["shared"]
        hs = act(xf @ sh["wg"].to(x.dtype)) * (xf @ sh["wi"].to(x.dtype))
        y = y + hs @ sh["wo"].to(x.dtype)
    return y.reshape(b, s, d)
