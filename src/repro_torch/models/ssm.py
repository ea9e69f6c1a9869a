"""Mamba2 (state-space duality / SSD) blocks: chunked train scan + O(1)
decode (the reference's `repro.models.ssm`).

Follows the SSD algorithm of Dao & Gu (arXiv 2405.21060): within-chunk
"attention-like" diagonal blocks + inter-chunk recurrence on the
(H, P, N) state, all in exact einsum form.  Decode keeps a constant-size
recurrent state plus a depthwise-conv ring buffer.  The depthwise conv
stays a sum of shifted products, as in the reference (a library
convolution would change the float32 rounding).
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed import hints
from repro_torch.distributed.sharding import P, placements
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, device_of, init_rms,
                                       normal_init, rms_norm)


def init_ssm(gen, cfg: ModelConfig) -> Dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = di + 2 * g * n
    dev = device_of(gen)
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * g * n + h)),
        "conv": normal_init(gen, (cfg.ssm_conv, conv_ch), 0.1),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "norm": init_rms(di, dev),
        "out_proj": dense_init(gen, (di, d)),
    }


def _segsum(dA):
    """dA: (..., L) -> (..., L, L) with out[i,j] = sum_{j<k<=i} dA_k (i>=j)."""
    L = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def _split_proj(params, x, cfg: ModelConfig):
    di = cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    proj = x @ params["in_proj"].to(x.dtype)
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * g * n]
    dt = proj[..., -h:]
    return z, xbc, dt


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-off
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_core(xbc, dt, kw, a_log, dt_bias, d_skip, init_state=None,
              init_conv=None, *, cfg: ModelConfig, h0: int, h1: int):
    """The conv and the chunked scan of heads ``h0:h1``.  xbc: the
    (B, T, ch) conv input of every channel; dt: (B, T, H) before the
    softplus.  Returns (y (B, T, (h1 - h0) * P) float32, final state
    (B, h1 - h0, P, N))."""
    b, t, _ = xbc.shape
    di = cfg.d_inner
    g, n, h, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    hl = h1 - h0
    ck = min(cfg.ssm_chunk, t)
    assert t % ck == 0
    nc = t // ck
    if init_conv is not None:
        pad = init_conv.to(xbc.dtype)
    else:
        pad = torch.zeros((b, cfg.ssm_conv - 1, xbc.shape[-1]),
                          dtype=xbc.dtype, device=xbc.device)
    if hl != h:
        # this device's heads: their x channels and every B / C channel
        sel = torch.cat([torch.arange(h0 * p, h1 * p),
                         torch.arange(di, di + 2 * g * n)]).to(xbc.device)
        xbc, pad, kw = xbc[..., sel], pad[..., sel], kw[:, sel]
    # causal depthwise conv over (x, B, C) channels
    xpad = torch.cat([pad, xbc], dim=1)
    conv = sum(xpad[:, i: i + t] * kw[i][None, None]
               for i in range(cfg.ssm_conv))
    conv = F.silu(conv)
    dl = hl * p
    xs = conv[..., :dl].reshape(b, t, hl, p)
    bmat = conv[..., dl: dl + g * n].reshape(b, t, g, n)
    cmat = conv[..., dl + g * n:].reshape(b, t, g, n)

    a = -torch.exp(a_log[h0:h1]).float()                    # (h,)
    dt = _softplus(dt[..., h0:h1].float() + dt_bias[h0:h1][None, None])
    dA = dt * a[None, None]                                 # (b,t,h)

    # chunked views
    xc = xs.reshape(b, nc, ck, hl, p)
    bc = torch.repeat_interleave(bmat.reshape(b, nc, ck, g, n), h // g,
                                 dim=3)[:, :, :, h0:h1]
    cc = torch.repeat_interleave(cmat.reshape(b, nc, ck, g, n), h // g,
                                 dim=3)[:, :, :, h0:h1]
    dtc = dt.reshape(b, nc, ck, hl)
    dAc = dA.reshape(b, nc, ck, hl)
    xdt = (xc * dtc[..., None]).float()

    # 1) within-chunk (diagonal blocks)
    lmat = torch.exp(_segsum(dAc.transpose(-1, -2)))        # (b,nc,h,ck,ck)
    y_diag = torch.einsum("bclhn,bchls,bcshn,bcshp->bclhp",
                          cc.float(), lmat, bc.float(), xdt)

    # 2) per-chunk states
    cs = torch.cumsum(dAc, dim=2)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)         # (b,nc,ck,h)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn",
                          bc.float(), decay_to_end, xdt)

    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(cs[:, :, -1, :])                # (b,nc,h)
    carry = (torch.zeros((b, hl, p, n), dtype=torch.float32,
                         device=xbc.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)                                  # the PREV state
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    final = carry
    prev_states = torch.stack(prev, dim=1)                  # (b,nc,h,p,n)

    # 4) contribution of carried-in state
    decay_from_start = torch.exp(cs)                        # (b,nc,ck,h)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp",
                         cc.float(), prev_states, decay_from_start)

    y = (y_diag + y_off).reshape(b, t, hl, p)
    y = y + xs.float() * d_skip[h0:h1][None, None, :, None]
    return y.reshape(b, t, dl), final


def _ssd_parallel(core, h: int, xbc, dt, params, init_state, init_conv):
    """``core`` over every head (plain tensors), or through `local_map`
    on DTensors: each device takes its shard of the batch and, when the
    heads divide the model axis, its own heads (the reference's cache
    layout shards the state by head).  The conv input and dt come in
    replicated over the model axis, and every input a device reads only
    in part gets a partial-sum gradient.  No caller continues a scan
    from a carried state on a mesh, so that path takes none."""
    args = [xbc, dt, params["conv"].to(xbc.dtype), params["a_log"],
            params["dt_bias"], params["d_skip"]]
    if not isinstance(xbc, DTensor):
        return core(*args, init_state, init_conv, h0=0, h1=h)
    if init_state is not None or init_conv is not None:
        raise NotImplementedError("ssd_scan on DTensors starts from a zero "
                                  "state and conv buffer")
    mesh = xbc.device_mesh
    model = hints.model_axis()
    msize = hints.axis_size("MODEL")
    bax = hints.resolve(xbc.shape, ("BATCH",))[0]
    split = model is not None and h % msize == 0
    m_ax = model if split else None
    act = placements(mesh, P(bax))
    rep = placements(mesh, P())
    partial_over = set(bax or ()) | ({model} if split else set())
    g_act = tuple(Partial() if mesh.mesh_dim_names[i] == model and split
                  else pl for i, pl in enumerate(act))
    g_par = tuple(Partial() if name in partial_over else pl
                  for name, pl in zip(mesh.mesh_dim_names, rep))
    hl = h // msize if split else h
    h0 = mesh.get_local_rank(model) * hl if split else 0
    fn = local_map(functools.partial(core, h0=h0, h1=h0 + hl),
                   out_placements=(placements(mesh, P(bax, None, m_ax)),
                                   placements(mesh, P(bax, m_ax))),
                   in_placements=(act, act) + (rep,) * 4,
                   in_grad_placements=(g_act, g_act) + (g_par,) * 4,
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)


def ssd_scan(params: Dict, x, cfg: ModelConfig,
             init_state=None, init_conv=None):
    """x: (B, T, d_model) with T % chunk == 0. Returns (y, final_state)."""
    b, t, _ = x.shape
    h = cfg.ssm_nheads
    z, xbc, dt = _split_proj(params, x, cfg)
    pad = (init_conv.to(x.dtype) if init_conv is not None else
           torch.zeros_like(xbc[:, :1]).expand(b, cfg.ssm_conv - 1, -1))
    new_conv = torch.cat([pad, xbc], dim=1)[:, t:]          # ring buffer tail
    core = functools.partial(_ssd_core, cfg=cfg)
    y, final = _ssd_parallel(core, h, xbc, dt, params, init_state,
                             init_conv)
    y = y.to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = y @ params["out_proj"].to(x.dtype)
    return out, (final, new_conv)


def _ssd_decode_core(window, dt, state, kw, a_log, dt_bias, d_skip, *,
                     cfg: ModelConfig, h0: int, h1: int):
    """One step of heads ``h0:h1``.  window: (B, K, ch) the conv buffer
    and the new input of every channel; dt: (B, 1, H); state: (B,
    h1 - h0, P, N).  Returns (y (B, 1, (h1 - h0) * P) float32, state)."""
    b = window.shape[0]
    di = cfg.d_inner
    g, n, h, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    hl = h1 - h0
    if hl != h:
        sel = torch.cat([torch.arange(h0 * p, h1 * p),
                         torch.arange(di, di + 2 * g * n)]).to(window.device)
        window, kw = window[..., sel], kw[:, sel]
    conv = torch.einsum("bkc,kc->bc", window, kw)[:, None]
    conv = F.silu(conv)
    dl = hl * p
    xs = conv[..., :dl].reshape(b, hl, p)
    bmat = torch.repeat_interleave(conv[..., dl: dl + g * n].reshape(b, g, n),
                                   h // g, dim=1)[:, h0:h1]
    cmat = torch.repeat_interleave(conv[..., dl + g * n:].reshape(b, g, n),
                                   h // g, dim=1)[:, h0:h1]

    a = -torch.exp(a_log[h0:h1]).float()
    dts = _softplus(dt[:, 0, h0:h1].float() + dt_bias[h0:h1][None])
    dA = torch.exp(dts * a[None])                           # (b,h)
    state = (state.float() * dA[:, :, None, None]
             + torch.einsum("bh,bhn,bhp->bhpn", dts, bmat.float(), xs.float()))
    y = torch.einsum("bhn,bhpn->bhp", cmat.float(), state)
    y = y + xs.float() * d_skip[h0:h1][None, :, None]
    return y.reshape(b, 1, dl), state


def ssd_decode(params: Dict, x, cfg: ModelConfig, state, conv_buf):
    """Single-token step. x: (B,1,d); state (B,H,P,N); conv_buf (B,K-1,ch)."""
    h = cfg.ssm_nheads
    z, xbc, dt = _split_proj(params, x, cfg)
    window = torch.cat([conv_buf.to(x.dtype), xbc], dim=1)
    new_buf = window[:, 1:]
    args = [window, dt, state, params["conv"].to(x.dtype), params["a_log"],
            params["dt_bias"], params["d_skip"]]
    core = functools.partial(_ssd_decode_core, cfg=cfg)
    if not isinstance(window, DTensor):
        y, state = core(*args, h0=0, h1=h)
    else:
        mesh = window.device_mesh
        model = hints.model_axis()
        msize = hints.axis_size("MODEL")
        bax = hints.resolve(window.shape, ("BATCH",))[0]
        split = model is not None and h % msize == 0
        m_ax = model if split else None
        hl = h // msize if split else h
        h0 = mesh.get_local_rank(model) * hl if split else 0
        act, rep = placements(mesh, P(bax)), placements(mesh, P())
        p_state = placements(mesh, P(bax, m_ax))
        y, state = local_map(
            functools.partial(core, h0=h0, h1=h0 + hl),
            out_placements=(placements(mesh, P(bax, None, m_ax)), p_state),
            in_placements=(act, act, p_state) + (rep,) * 4,
            device_mesh=mesh, redistribute_inputs=True)(*args)
    y = y.to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["out_proj"].to(x.dtype), state, new_buf
