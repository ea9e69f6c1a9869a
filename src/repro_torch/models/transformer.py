"""Model assembly for all LM architecture families (the reference's
`repro.models.transformer` on torch tensors).

Functional style: a parameter tree is nested dicts of tensors with the
reference's keys, uniform layer stacks keep the reference's leading
layer axis, and pure functions give init / forward / loss / cache /
decode step.  So checkpoints, `repro_torch.interop` and the parity
tests walk both packages' trees the same way.

Layers run in a Python loop over the stacked layer axis.  ``remat``
wraps each layer in `torch.utils.checkpoint` (the forward is replayed
in the backward pass); ``remat_policy="dots"`` checkpoints selectively,
saving the outputs of the unbatched matmuls, as the reference's
``dots_with_no_batch_dims_saveable``.  ``scan_layers`` only shapes the
reference's XLA program (a scan or an unrolled loop): both are this
loop.  ``seq_shard_carry``, ``blockwise_anchor`` and ``fsdp`` place
tensors on a device mesh (DTensor parameters, `repro_torch.distributed`);
on plain tensors they change nothing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.distributed import hints
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blockwise import blockwise_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, cross_entropy, dense_init,
                                       device_of, embed, init_mlp, init_rms,
                                       mlp, normal_init, rms_norm)
from repro_torch.tree import tree_leaves, tree_map, tree_stack, tree_unstack

DENSE_ATTN_MAX_SEQ = 2048     # above this, use blockwise attention


def _carry(x):
    """The residual stream: on a mesh, sharded over the batch axes and
    replicated over the model axis (a model-parallel product's partial
    sums are reduced here, not left to DTensor's choice of layout)."""
    return hints.constrain(x, ("BATCH",) + (None,) * (x.ndim - 1))


def _n_layers(blocks) -> int:
    return tree_leaves(blocks)[0].shape[0]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _init_dense_block(gen, cfg: ModelConfig) -> Dict:
    p = {
        "ln1": init_rms(cfg.d_model, device_of(gen)),
        "ln2": init_rms(cfg.d_model, device_of(gen)),
        "attn": (attn_mod.init_mla(gen, cfg) if cfg.mla
                 else attn_mod.init_attention(gen, cfg)),
    }
    if cfg.is_moe:
        p["moe"] = moe_mod.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff)
    return p


def _init_cross_block(gen, cfg: ModelConfig) -> Dict:
    return {
        "ln1": init_rms(cfg.d_model, device_of(gen)),
        "ln2": init_rms(cfg.d_model, device_of(gen)),
        "ln3": init_rms(cfg.d_model, device_of(gen)),
        "attn": attn_mod.init_attention(gen, cfg),
        "cross": attn_mod.init_attention(gen, cfg),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff),
    }


def _stack(n: int, fn):
    return tree_stack([fn() for _ in range(n)])


def init_params(cfg: ModelConfig, gen) -> Dict:
    """Float32 parameters on ``gen``'s device: normal x 0.02 for the
    embedding, uniform +-1/sqrt(fan_in) for dense layers, ones for norms
    (the reference's distributions, drawn from ``gen``)."""
    d, v = cfg.d_model, cfg.vocab
    dev = device_of(gen)
    params: Dict[str, Any] = {
        "embed": normal_init(gen, (v, d), 0.02),
        "final_norm": init_rms(d, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (d, v))

    def ssm_block():
        return {"ln": init_rms(d, dev), "ssm": ssm_mod.init_ssm(gen, cfg)}

    if cfg.family == "ssm":
        params["blocks"] = _stack(cfg.n_layers, ssm_block)
    elif cfg.family == "hybrid":
        params["blocks"] = _stack(cfg.n_layers, ssm_block)
        params["shared_attn"] = _init_dense_block(gen, cfg)
    elif cfg.family == "encdec":
        params["enc"] = _stack(cfg.enc_layers,
                               lambda: _init_dense_block(gen, cfg))
        params["dec"] = _stack(cfg.dec_layers,
                               lambda: _init_cross_block(gen, cfg))
    else:   # dense / moe / vlm
        n_moe = cfg.n_layers - cfg.first_dense
        if cfg.first_dense:
            dense_cfg = dataclasses.replace(cfg, n_experts=0)
            params["dense_blocks"] = _stack(
                cfg.first_dense, lambda: _init_dense_block(gen, dense_cfg))
        params["blocks"] = _stack(n_moe, lambda: _init_dense_block(gen, cfg))
    return params


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _attention_any(params, x, cfg: ModelConfig, positions, positions3):
    s = x.shape[1]
    if cfg.mla:
        return attn_mod.mla_attention(params, x, cfg, positions)
    if s > DENSE_ATTN_MAX_SEQ and not cfg.mrope_sections:
        b, _, d = x.shape
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = attn_mod.split_heads(x @ params["wq"].to(x.dtype), b, s, h, dh)
        k = attn_mod.split_heads(x @ params["wk"].to(x.dtype), b, s, kv, dh)
        v = attn_mod.split_heads(x @ params["wv"].to(x.dtype), b, s, kv, dh)
        if cfg.qk_norm:
            q = rms_norm(q, params["q_norm"])
            k = rms_norm(k, params["k_norm"])
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = blockwise_attention(q, k, v, causal=cfg.causal,
                                  anchor=cfg.blockwise_anchor)
        out = out.reshape(b, s, h * dh) @ params["wo"].to(x.dtype)
        return out, (k, v)
    return attn_mod.attention(params, x, cfg, positions,
                              positions3=positions3)


def _dense_block_fwd(blk, x, cfg: ModelConfig, positions, positions3=None,
                     collect_cache: bool = False):
    if cfg.seq_shard_carry:
        # Megatron-SP: the residual carry lives S-sharded over 'model'
        # (the carry and the remat-saved input shrink by the model
        # axis); gather S here, re-shard at block exit.
        x = hints.constrain(x, ("BATCH", None, None))
    h, kvc = _attention_any(blk["attn"], rms_norm(x, blk["ln1"]), cfg,
                            positions, positions3)
    x = _carry(x + h)
    y = rms_norm(x, blk["ln2"])
    if cfg.is_moe and "moe" in blk:
        x = _carry(x + moe_mod.moe_ffn(blk["moe"], y, cfg))
    else:
        x = _carry(x + mlp(blk["mlp"], y, cfg.act))
    if cfg.seq_shard_carry:
        x = hints.constrain(x, ("BATCH", "MODEL", None))
    return (x, kvc) if collect_cache else (x, None)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save unbatched matmul outputs (x @ W lowers to ``mm``), recompute
    the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str = "full"):
    """``fn`` replayed in the backward pass (only while autograd
    records); "dots" saves the unbatched matmul outputs."""
    kwargs = {"use_reentrant": False}
    if policy == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, **kwargs)
    return wrapped


def _scan_blocks(blocks, x, fwd, remat: bool, collect=False,
                 scan: bool = True, remat_policy: str = "full"):
    """Run ``fwd(blk, carry) -> (carry, stash)`` over the stacked layer
    axis; stacked stashes (or None).  ``scan`` is the reference's XLA
    choice between a scan and an unrolled loop: both are this loop."""
    del scan

    def gathered(blk, carry):      # FSDP: the layer's weights, then the layer
        return fwd(hints.gather_weights(blk), carry)
    body = _remat(gathered, remat_policy) if remat else gathered
    stashes = []
    for blk in tree_unstack(blocks):
        x, stash = body(blk, x)
        stashes.append(stash)
    if stashes and stashes[0] is not None:
        return x, tree_stack(stashes)
    return x, None


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _head(cfg: ModelConfig, params: Dict, x):
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    head = hints.gather_weights(head)
    return x @ head.to(x.dtype)


def forward(cfg: ModelConfig, params: Dict, batch: Dict,
            collect_cache: bool = False, head_last_only: bool = False):
    """Returns (logits, caches) for LM-style models (incl. vlm/ssm/hybrid).

    head_last_only: compute logits only for the final position (prefill
    serving path -- avoids the full (B,S,V) logit tensor)."""
    if cfg.family == "encdec":
        return _forward_encdec(cfg, params, batch, collect_cache,
                               head_last_only)
    if "embeds" in batch:
        x = batch["embeds"].to(_dt(cfg))
        b, s = x.shape[:2]
    else:
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed(params["embed"].to(_dt(cfg)), tokens)
    positions = _positions(b, s, x.device)
    positions3 = batch.get("positions3")

    caches = None
    if cfg.family in ("ssm", "hybrid"):
        def blk_fwd(blk, carry):
            y, st = ssm_mod.ssd_scan(blk["ssm"], rms_norm(carry, blk["ln"]),
                                     cfg)
            return _carry(carry + y), (st if collect_cache else None)

        if cfg.family == "ssm":
            x, caches = _scan_blocks(params["blocks"], x, blk_fwd, cfg.remat,
                                     collect_cache,
                                     remat_policy=cfg.remat_policy)
        else:
            # zamba2-style: shared attention block every cfg.attn_every layers
            per = cfg.attn_every
            shared_fwd = functools.partial(_dense_block_fwd, cfg=cfg,
                                           positions=positions)
            if cfg.remat:
                shared_fwd = _remat(shared_fwd)
            cache_list = []
            for gidx in range(cfg.n_layers // per):
                # as in the reference, no shared-attention cache is kept
                x, _ = shared_fwd(hints.gather_weights(params["shared_attn"]),
                                  x)
                grp = tree_map(lambda p: p[gidx * per:(gidx + 1) * per],
                               params["blocks"])
                x, st = _scan_blocks(grp, x, blk_fwd, cfg.remat,
                                     collect_cache,
                                     remat_policy=cfg.remat_policy)
                cache_list.append((None, st))
            caches = cache_list if collect_cache else None
    else:
        def blk_fwd(blk, carry):
            return _dense_block_fwd(blk, carry, cfg, positions, positions3,
                                    collect_cache)

        if cfg.first_dense:
            x, _ = _scan_blocks(params["dense_blocks"], x, blk_fwd,
                                cfg.remat, collect_cache,
                                remat_policy=cfg.remat_policy)
        x, caches = _scan_blocks(params["blocks"], x, blk_fwd, cfg.remat,
                                 collect_cache,
                                 remat_policy=cfg.remat_policy)

    if head_last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"])
    return _head(cfg, params, x), caches


def _forward_encdec(cfg: ModelConfig, params: Dict, batch: Dict,
                    collect_cache: bool, head_last_only: bool = False):
    enc_x = batch["frames"].to(_dt(cfg))
    b, t_src = enc_x.shape[:2]
    enc_pos = _positions(b, t_src, enc_x.device)
    enc_cfg = dataclasses.replace(cfg, causal=False)

    def enc_fwd(blk, carry):
        out, _ = _dense_block_fwd(blk, carry, enc_cfg, enc_pos)
        return out, None

    enc_out, _ = _scan_blocks(params["enc"], enc_x, enc_fwd, cfg.remat)

    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = embed(params["embed"].to(_dt(cfg)), tokens)
    pos = _positions(b, s, x.device)
    kv, dh = cfg.n_kv_heads, cfg.head_dim

    def dec_fwd(blk, carry):
        h, kvc = attn_mod.attention(blk["attn"], rms_norm(carry, blk["ln1"]),
                                    cfg, pos)
        carry = _carry(carry + h)
        # cross attention over encoder output
        y = rms_norm(carry, blk["ln2"])
        k = attn_mod.split_heads(enc_out @ blk["cross"]["wk"].to(carry.dtype),
                                 b, t_src, kv, dh)
        v = attn_mod.split_heads(enc_out @ blk["cross"]["wv"].to(carry.dtype),
                                 b, t_src, kv, dh)
        h2, _ = attn_mod.attention(blk["cross"], y, enc_cfg, pos,
                                   kv_override=(k, v))
        carry = _carry(carry + h2)
        carry = _carry(carry + mlp(blk["mlp"], rms_norm(carry, blk["ln3"]),
                                   cfg.act))
        return carry, (kvc if collect_cache else None)

    x, caches = _scan_blocks(params["dec"], x, dec_fwd, cfg.remat,
                             collect_cache)
    if head_last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"])
    return _head(cfg, params, x), (enc_out, caches)


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict):
    logits, _ = forward(cfg, params, batch)
    return cross_entropy(logits, batch["labels"], cfg.vocab)


def _dt(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Serving: cache init + decode step
# ---------------------------------------------------------------------------

def make_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Dict:
    dt = _dt(cfg)

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    if cfg.family in ("ssm", "hybrid"):
        cache = {
            "state": z(cfg.n_layers, batch, cfg.ssm_nheads, cfg.ssm_headdim,
                       cfg.ssm_state, dtype=torch.float32),
            "conv": z(cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
        }
        if cfg.family == "hybrid":
            n_groups = cfg.n_layers // cfg.attn_every
            cache["k"] = z(n_groups, batch, max_seq, cfg.n_kv_heads,
                           cfg.head_dim)
            cache["v"] = z(n_groups, batch, max_seq, cfg.n_kv_heads,
                           cfg.head_dim)
        return cache
    if cfg.mla:
        n = cfg.n_layers
        return {"ckv": z(n, batch, max_seq, cfg.kv_lora_rank),
                "kpe": z(n, batch, max_seq, cfg.qk_rope_dim)}
    n = cfg.dec_layers if cfg.family == "encdec" else cfg.n_layers
    shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": z(*shape), "v": z(*shape)}
    if cfg.family == "encdec":
        # cross-attention K/V precomputed at prefill over source frames
        cache["xk"], cache["xv"] = z(*shape), z(*shape)
    return cache


def _ffn(blk, carry, cfg: ModelConfig):
    y = rms_norm(carry, blk["ln2"])
    if cfg.is_moe and "moe" in blk:
        return _carry(carry + moe_mod.moe_ffn(blk["moe"], y, cfg))
    return _carry(carry + mlp(blk["mlp"], y, cfg.act))


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, token, pos,
                positions3=None):
    """One decode step. token: (B,) int (or embeds (B,1,d) for vlm);
    pos: scalar int. Returns (logits (B,V), new_cache)."""
    dt = _dt(cfg)
    pos = int(pos)
    if cfg.family in ("ssm", "hybrid"):
        return _decode_ssm(cfg, params, cache, token, pos)
    if token.ndim == 1:
        x = embed(params["embed"].to(dt), token)[:, None, :]
    else:
        x = token.to(dt)

    if cfg.family == "encdec":
        return _decode_encdec(cfg, params, cache, x, pos)

    if cfg.mla:
        def run(blocks, x, ckvs, kpes):
            outs_c, outs_p = [], []
            for i in range(_n_layers(blocks)):
                blk = tree_map(lambda a: a[i], blocks)
                h, c, p = attn_mod.mla_decode(
                    blk["attn"], rms_norm(x, blk["ln1"]), cfg, ckvs[i],
                    kpes[i], pos)
                x = _ffn(blk, x + h, cfg)
                outs_c.append(c)
                outs_p.append(p)
            return x, outs_c, outs_p

        nd = cfg.first_dense
        c0 = p0 = []
        if nd:
            x, c0, p0 = run(params["dense_blocks"], x, cache["ckv"][:nd],
                            cache["kpe"][:nd])
        x, c1, p1 = run(params["blocks"], x, cache["ckv"][nd:],
                        cache["kpe"][nd:])
        new_cache = {"ckv": torch.stack(c0 + c1),
                     "kpe": torch.stack(p0 + p1)}
    else:
        ks, vs = [], []
        blocks = params["blocks"]
        for i in range(_n_layers(blocks)):
            blk = tree_map(lambda a: a[i], blocks)
            h, ck, cv = attn_mod.decode_attention(
                blk["attn"], rms_norm(x, blk["ln1"]), cfg, cache["k"][i],
                cache["v"][i], pos, positions3)
            x = _ffn(blk, x + h, cfg)
            ks.append(ck)
            vs.append(cv)
        new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}

    x = rms_norm(x, params["final_norm"])
    return _head(cfg, params, x)[:, 0], new_cache


def _decode_ssm(cfg: ModelConfig, params, cache, token, pos: int):
    dt = _dt(cfg)
    x = embed(params["embed"].to(dt), token)[:, None, :]

    def run(blocks, x, states, convs):
        out_s, out_c = [], []
        for i in range(_n_layers(blocks)):
            blk = tree_map(lambda a: a[i], blocks)
            y, st, cb = ssm_mod.ssd_decode(blk["ssm"], rms_norm(x, blk["ln"]),
                                           cfg, states[i], convs[i])
            x = _carry(x + y)
            out_s.append(st)
            out_c.append(cb)
        return x, out_s, out_c

    if cfg.family == "ssm":
        x, ns, ncv = run(params["blocks"], x, cache["state"], cache["conv"])
        new_cache = {"state": torch.stack(ns), "conv": torch.stack(ncv)}
    else:
        per = cfg.attn_every
        shared = params["shared_attn"]
        states, convs, ks, vs = [], [], [], []
        for gidx in range(cfg.n_layers // per):
            h, ck, cv = attn_mod.decode_attention(
                shared["attn"], rms_norm(x, shared["ln1"]), cfg,
                cache["k"][gidx], cache["v"][gidx], pos)
            x = _carry(x + h)
            x = _carry(x + mlp(shared["mlp"], rms_norm(x, shared["ln2"]),
                               cfg.act))
            ks.append(ck)
            vs.append(cv)
            lo, hi = gidx * per, (gidx + 1) * per
            grp = tree_map(lambda p: p[lo:hi], params["blocks"])
            x, st, cb = run(grp, x, cache["state"][lo:hi],
                            cache["conv"][lo:hi])
            states += st
            convs += cb
        new_cache = {"state": torch.stack(states),
                     "conv": torch.stack(convs),
                     "k": torch.stack(ks), "v": torch.stack(vs)}
    x = rms_norm(x, params["final_norm"])
    return _head(cfg, params, x)[:, 0], new_cache


def _decode_encdec(cfg: ModelConfig, params, cache, x, pos: int):
    q_cfg = dataclasses.replace(cfg, causal=False)
    ks, vs = [], []
    dec = params["dec"]
    for i in range(_n_layers(dec)):
        blk = tree_map(lambda a: a[i], dec)
        h, ck, cv = attn_mod.decode_attention(
            blk["attn"], rms_norm(x, blk["ln1"]), cfg, cache["k"][i],
            cache["v"][i], pos)
        x = _carry(x + h)
        y = rms_norm(x, blk["ln2"])
        h2, _ = attn_mod.attention(blk["cross"], y, q_cfg, None,
                                   kv_override=(cache["xk"][i].to(x.dtype),
                                                cache["xv"][i].to(x.dtype)))
        x = _carry(x + h2)
        x = _carry(x + mlp(blk["mlp"], rms_norm(x, blk["ln3"]), cfg.act))
        ks.append(ck)
        vs.append(cv)
    new_cache = dict(cache)
    new_cache["k"], new_cache["v"] = torch.stack(ks), torch.stack(vs)
    x = rms_norm(x, params["final_norm"])
    return _head(cfg, params, x)[:, 0], new_cache
