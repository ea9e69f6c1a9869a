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

from typing import Dict

import torch
import torch.nn.functional as F

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


def ssd_scan(params: Dict, x, cfg: ModelConfig,
             init_state=None, init_conv=None):
    """x: (B, T, d_model) with T % chunk == 0. Returns (y, final_state)."""
    b, t, _ = x.shape
    di = cfg.d_inner
    g, n, h, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    ck = min(cfg.ssm_chunk, t)
    assert t % ck == 0
    nc = t // ck

    z, xbc, dt = _split_proj(params, x, cfg)
    # causal depthwise conv over (x, B, C) channels
    kw = params["conv"].to(x.dtype)
    if init_conv is not None:
        pad = init_conv.to(x.dtype)
    else:
        pad = torch.zeros((b, cfg.ssm_conv - 1, xbc.shape[-1]),
                          dtype=x.dtype, device=x.device)
    xpad = torch.cat([pad, xbc], dim=1)
    conv = sum(xpad[:, i: i + t] * kw[i][None, None]
               for i in range(cfg.ssm_conv))
    conv = F.silu(conv)
    new_conv = xpad[:, t:]                                  # ring buffer tail
    xs = conv[..., :di].reshape(b, t, h, p)
    bmat = conv[..., di: di + g * n].reshape(b, t, g, n)
    cmat = conv[..., di + g * n:].reshape(b, t, g, n)

    a = -torch.exp(params["a_log"]).float()                 # (h,)
    dt = _softplus(dt.float() + params["dt_bias"][None, None])  # (b,t,h)
    dA = dt * a[None, None]                                 # (b,t,h)

    # chunked views
    xc = xs.reshape(b, nc, ck, h, p)
    bc = torch.repeat_interleave(bmat.reshape(b, nc, ck, g, n), h // g, dim=3)
    cc = torch.repeat_interleave(cmat.reshape(b, nc, ck, g, n), h // g, dim=3)
    dtc = dt.reshape(b, nc, ck, h)
    dAc = dA.reshape(b, nc, ck, h)
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
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
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

    y = (y_diag + y_off).reshape(b, t, h, p)
    y = y + xs.float() * params["d_skip"][None, None, :, None]
    y = y.reshape(b, t, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = y @ params["out_proj"].to(x.dtype)
    return out, (final, new_conv)


def ssd_decode(params: Dict, x, cfg: ModelConfig, state, conv_buf):
    """Single-token step. x: (B,1,d); state (B,H,P,N); conv_buf (B,K-1,ch)."""
    b = x.shape[0]
    di = cfg.d_inner
    g, n, h, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    z, xbc, dt = _split_proj(params, x, cfg)
    kw = params["conv"].to(x.dtype)
    window = torch.cat([conv_buf.to(x.dtype), xbc], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, kw)[:, None]
    conv = F.silu(conv)
    new_buf = window[:, 1:]
    xs = conv[..., :di].reshape(b, h, p)
    bmat = torch.repeat_interleave(conv[..., di: di + g * n].reshape(b, g, n),
                                   h // g, dim=1)
    cmat = torch.repeat_interleave(conv[..., di + g * n:].reshape(b, g, n),
                                   h // g, dim=1)

    a = -torch.exp(params["a_log"]).float()
    dts = _softplus(dt[:, 0].float() + params["dt_bias"][None])
    dA = torch.exp(dts * a[None])                           # (b,h)
    state = (state.float() * dA[:, :, None, None]
             + torch.einsum("bh,bhn,bhp->bhpn", dts, bmat.float(), xs.float()))
    y = torch.einsum("bhn,bhpn->bhp", cmat.float(), state)
    y = y + xs.float() * params["d_skip"][None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["out_proj"].to(x.dtype), state, new_buf
