"""Blockwise (flash-style) attention: online softmax over KV chunks
inside a loop over q chunks (the reference's `repro.models.blockwise`).

Taken by the transformer only above ``DENSE_ATTN_MAX_SEQ``, where the
dense (S x T) score tensor no longer fits.

On DTensors the whole loop runs on each device's shard of the batch and
the heads (`attention.head_parallel`), which is the reference's
``anchor``: it pins the kv-group axis to MODEL, because SPMD otherwise
loses the head sharding across the reshape + scan boundary and
re-gathers q/k/v inside the kv-chunk loop.  "auto" (and "off") keep
the kv heads on MODEL when they divide it and otherwise shard the q
heads alone; "on" with a kv count that does not divide the model axis
replicates the heads over it (the reference's one up-front gather per
layer, a win for wide archs, a loss for small ones).  On one device
the policy has nothing to pin.

Causal attention stops a q chunk's kv loop at the first kv chunk that
lies wholly after it: such a chunk's scores are all NEG_INF, so its
weights are exactly 0 and its correction exactly 1 (the reference scans
it anyway).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.distributed import hints
from repro_torch.models.attention import head_parallel

NEG_INF = -1e9


def blockwise_attention(q, k, v, *, causal: bool, q_chunk: int = 1024,
                        kv_chunk: int = 1024, anchor: str = "auto"):
    """q: (B,S,H,D), k/v: (B,T,KV,D) grouped-query; returns (B,S,H,D)."""
    replicate = anchor == "on" and k.shape[2] % hints.axis_size("MODEL") != 0
    return head_parallel(functools.partial(
        _blockwise, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk),
        q, k, v, replicate=replicate)


def _blockwise(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int):
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    nq, nk = s // q_chunk, t // kv_chunk
    assert s % q_chunk == 0 and t % kv_chunk == 0

    qg = q.reshape(b, nq, q_chunk, kv, g, d)
    kc = k.reshape(b, nk, kv_chunk, kv, d)
    vc = v.reshape(b, nk, kv_chunk, kv, d)
    scale = 1.0 / np.sqrt(d)
    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi]
        acc = torch.zeros((b, kv, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, kv, g, q_chunk), -torch.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        for ki in range(nk):
            if causal and ki * kv_chunk >= (qi + 1) * q_chunk:
                break                   # masked whole: adds exactly 0
            k_blk, v_blk = kc[:, ki], vc[:, ki]
            scores = torch.einsum("bskgd,btkd->bkgst", q_blk, k_blk) * scale
            scores = scores.float()
            if causal:
                qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
                kpos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                scores = torch.where(mask[None, None, None], scores, NEG_INF)
            m_new = torch.maximum(m, torch.amax(scores, dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p, v_blk.float())
            l = l * corr + torch.sum(p, dim=-1)
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        # emit in q's dtype at once: halves the stacked q-block outputs
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))   # (b,qc,kv,g,d)
    out = torch.stack(outs, dim=1).reshape(b, s, h, d)
    return out.to(q.dtype)
