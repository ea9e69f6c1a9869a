"""Mixture-of-experts with sorted capacity dispatch (the reference's
`repro.models.moe`, one-device path).

Tokens-choose-experts top-k routing; assignments are sorted by expert
(a STABLE sort: capacity slots follow token order within an expert) and
scattered into an (E, C, d) buffer, so expert FFN compute scales with
top_k, not E.  Assignments beyond capacity go to one extra overflow row
that is then dropped (capacity_factor controls the head-room).

Distribution (GShard/Switch pattern), on DTensors: the token->slot
gather/scatter has data-dependent indices, so each data shard routes
its own tokens into its own capacity slice (C_local = C / n_shards) in
a `local_map` over the batch axes, the reference's per-shard
``shard_map``; the only cross-device movement left is the (E, C, d)
buffer's redistribution of the expert axis onto 'model', the
irreducible expert-parallel traffic.  With experts on 'model' each
model shard combines its own experts' outputs into a partial (n_loc, d)
sum that is reduced over 'model' (the reference's ``psum``).  Plain
tensors (one device) take the unsharded path unchanged.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import hints
from repro_torch.distributed.sharding import P, placements
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

    if isinstance(xf, DTensor):
        y = _moe_mesh(params, xf, cfg, cap, act)
    else:
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


def _with_partial(mesh, pl, names) -> tuple:
    """``pl`` with Partial() on the mesh dims named in ``names``."""
    return tuple(Partial() if name in names else p
                 for name, p in zip(mesh.mesh_dim_names, pl))


def _moe_mesh(params: Dict, xf: DTensor, cfg: ModelConfig, cap: int, act):
    """The routed experts on DTensors: (n, d) tokens -> (n, d)."""
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xf.dtype
    mesh = xf.device_mesh
    bax = hints.batch_axis_names()
    nshard = hints.axis_size("BATCH")
    model = hints.model_axis()
    msize = hints.axis_size("MODEL")
    per_shard = bool(bax) and nshard > 1 and n % nshard == 0 \
        and n // nshard >= k
    if per_shard:
        cap_loc, n_loc, b_ax = max(8, cap // nshard), n // nshard, bax
    else:     # one global dispatch, run alike on every device
        cap_loc, n_loc, b_ax = cap, n, None
    tok = placements(mesh, P(b_ax))                       # (n, ...)
    rep = placements(mesh, P())

    def dispatch_shard(xf_l, rw):
        buf_l, meta = _route_and_dispatch(xf_l, rw, e, k, cap_loc)
        return (buf_l,) + meta
    buf, st, sg, keep, slot = local_map(
        dispatch_shard,
        out_placements=(placements(mesh, P(None, b_ax)),) + (tok,) * 4,
        in_placements=(tok, rep),
        in_grad_placements=(tok, _with_partial(mesh, rep, b_ax or ())),
        device_mesh=mesh, redistribute_inputs=True)(xf, params["router"])
    # buf: (e, n_shards * cap_loc, d), the capacity sharded over the
    # batch axes; moving the expert axis onto 'model' is the all-to-all
    ep = e % msize == 0
    e_ax = "MODEL" if ep else None
    c_ax = "BATCH" if (per_shard or not ep) else None
    f_ax = None if ep else "MODEL"
    buf = hints.constrain(buf, (e_ax, c_ax, None))
    h = act(torch.bmm(buf, params["wg"].to(dt)))
    h = h * torch.bmm(buf, params["wi"].to(dt))
    h = hints.constrain(h, (e_ax, c_ax, f_ax))
    out_e = torch.bmm(h, params["wo"].to(dt))
    out_e = hints.constrain(out_e, (e_ax, c_ax, None))

    if per_shard and ep and model:
        # Combine without replicating the expert axis: each model shard
        # combines its e_loc experts' outputs into a partial (n_loc, d)
        # and the sum over 'model' completes it
        span = (e // msize) * cap_loc
        base = mesh.get_local_rank(model) * span

        def combine_shard(out_l, st_l, sg_l, keep_l, slot_l):
            mine = keep_l & (slot_l >= base) & (slot_l < base + span)
            out_flat = out_l.reshape(span, d)
            contrib = torch.where(
                mine[:, None],
                out_flat[torch.clamp(slot_l - base, 0, span - 1)]
                * sg_l[:, None].to(dt), 0)
            y_l = torch.zeros((n_loc, d), dtype=dt, device=out_l.device)
            return y_l.index_add(0, st_l, contrib.to(dt))
        p_out = placements(mesh, P(model, b_ax, None))
        y = local_map(
            combine_shard, out_placements=list(_with_partial(mesh, tok, (model,))),
            in_placements=(p_out,) + (tok,) * 4,
            in_grad_placements=(p_out, tok,
                                _with_partial(mesh, tok, (model,)), tok, tok),
            device_mesh=mesh, redistribute_inputs=True)(
                out_e, st, sg, keep, slot)
        y = y.redistribute(mesh, tok)                     # the psum
    else:
        def combine_shard(out_l, st_l, sg_l, keep_l, slot_l):
            return _combine(out_l, (st_l, sg_l, keep_l, slot_l), n_loc,
                            cap_loc, dt)
        p_out = placements(mesh, P(None, b_ax, None))
        y = local_map(
            combine_shard, out_placements=list(tok),
            in_placements=(p_out,) + (tok,) * 4,
            in_grad_placements=(p_out,) + (tok,) * 4,
            device_mesh=mesh, redistribute_inputs=True)(
                out_e, st, sg, keep, slot)
    return hints.constrain(y, ("BATCH", None))
