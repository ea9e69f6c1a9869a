"""Port model zoo against the reference, on the CPU.

For every LM architecture's smoke config in float32, the reference's
parameters (`init_params` from a JAX key, carried across with
`repro_torch.interop.params_from_reference`) go through both packages'
forward and loss on the same `SyntheticTokens` batch.  Tolerances:
logits within 1e-4 of the largest reference logit, the loss to rtol
1e-5, each gradient leaf within 1e-4 of its largest entry (float32
einsums contract in different orders; measured worst 1e-5, mamba2).
One bfloat16 loss is held to rtol 2e-3.  Each smoke config's
`decode_step` is held against the reference's from one random cache
(logits and new cache within 1e-4 of the largest entry), and MLA
decode, absorbed or not, against the full MLA pass and the
reference's.  Then the reference's
`tests/test_arch_smoke.py` contracts on the port (finite forward, grad
and decode step; SSM decode equal to the scan; GQA decode equal to full
attention; enc-dec decode), the MoE layer with capacity overflow, and
blockwise against dense attention at small chunks.  The reference runs
with ``ZKDL_EXEC_MODE=off`` (no on-disk executables)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as rreg
from repro.data import pipeline as rpipe
from repro.models import blockwise as rblock
from repro.models import moe as rmoe
from repro.models import transformer as rt
from repro_torch.configs import registry as treg
from repro_torch.interop import params_from_reference, params_to_reference
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import blockwise as tblock
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.tree import tree_leaves, tree_map

LM_ARCHS = [a for a in rreg.ARCHS if a != "fcnn_zkdl_16l"]
SEQ, B = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _reference_without_disk_executables():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKDL_EXEC_MODE", "off")
        yield


def _both(arch, **overrides):
    return (dataclasses.replace(rreg.smoke_config(arch), **overrides),
            dataclasses.replace(treg.smoke_config(arch), **overrides))


def _batch(rcfg, seed=3, step=1, seq=SEQ):
    np_batch = rpipe.SyntheticTokens(rcfg, seq, B, seed=seed).batch(step)
    return (np_batch, {k: torch.as_tensor(v) for k, v in np_batch.items()})


def _walk(ref, got, path=""):
    if isinstance(ref, dict):
        assert sorted(ref) == sorted(got), path
        for k in ref:
            yield from _walk(ref[k], got[k], f"{path}/{k}")
    else:
        yield path, np.asarray(ref, np.float32), got


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_float32_logits_loss_and_grads_match_reference(arch):
    rcfg, tcfg = _both(arch, dtype="float32")
    np_batch, batch = _batch(rcfg)
    from repro.models.layers import cross_entropy

    def loss_and_logits(p):
        logits, _ = rt.forward(rcfg, p, np_batch)
        return cross_entropy(logits, np_batch["labels"], rcfg.vocab), logits

    @jax.jit          # one XLA compile instead of one per op (seconds)
    def reference(key):
        p = rt.init_params(rcfg, key)
        return p, jax.value_and_grad(loss_and_logits, has_aux=True)(p)

    params, ((rloss, rlogits), rgrads) = reference(jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.device_get(params), "cpu")
    logits, _ = tt.forward(tcfg, tparams, batch)
    loss, grads = tsteps.value_and_grad(tcfg, tparams, batch)

    rlogits = np.asarray(rlogits)
    assert logits.shape == rlogits.shape == (B, SEQ, tcfg.vocab)
    assert np.abs(logits.numpy() - rlogits).max() <= \
        1e-4 * np.abs(rlogits).max()
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    n = 0
    for path, r, g in _walk(jax.device_get(rgrads), grads):
        assert g.shape == r.shape, path
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max() + 1e-9, \
            path
        n += 1
    assert n == len(tree_leaves(tparams))


def test_bfloat16_loss_matches_reference():
    rcfg, tcfg = _both("qwen3_0p6b")
    assert rcfg.dtype == "bfloat16"
    params = rt.init_params(rcfg, jax.random.PRNGKey(5))
    np_batch, batch = _batch(rcfg, seed=4)
    rloss = float(rt.loss_fn(rcfg, params, np_batch))
    loss = float(tt.loss_fn(tcfg, params_from_reference(
        jax.device_get(params), "cpu"), batch))
    np.testing.assert_allclose(loss, rloss, rtol=2e-3)


def test_param_tree_keys_and_shapes_match_reference():
    for arch in LM_ARCHS:
        rcfg, tcfg = _both(arch)
        ref = jax.eval_shape(lambda k: rt.init_params(rcfg, k),
                             jax.random.PRNGKey(0))
        got = tt.init_params(tcfg, torch.device("meta"))
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        names = ["/".join(k.key for k in path) for path, _ in flat]
        leaves = tree_leaves(got)
        assert len(leaves) == len(flat), arch
        for name, (_, r), g in zip(names, flat, leaves):
            assert tuple(g.shape) == tuple(r.shape), (arch, name)
            assert g.dtype == torch.float32 and g.device.type == "meta"


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_loss_and_grads(policy):
    """Layer remat (every full-size config has it on) replays the forward
    in the backward pass: the same loss and gradients as without it."""
    cfg = dataclasses.replace(treg.smoke_config("qwen3_0p6b"),
                              dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(1))
    _, batch = _batch(rreg.smoke_config("qwen3_0p6b"))
    loss, grads = tsteps.value_and_grad(cfg, params, batch)
    rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    rloss, rgrads = tsteps.value_and_grad(rcfg, params, batch)
    assert float(rloss) == float(loss)
    for g, r in zip(tree_leaves(grads), tree_leaves(rgrads)):
        torch.testing.assert_close(r, g, rtol=1e-6, atol=1e-9)


def test_init_distributions_and_interop_roundtrip():
    cfg = treg.smoke_config("deepseek_7b")
    gen = torch.Generator().manual_seed(0)
    p = tt.init_params(cfg, gen)
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    bound = 1 / np.sqrt(cfg.d_model)
    assert float(p["head"].abs().max()) <= bound
    assert float(p["head"].abs().max()) > 0.9 * bound
    assert bool((p["blocks"]["ln1"] == 1).all())
    again = tt.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(again)))
    host = params_to_reference(p)
    back = params_from_reference(host, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(back)))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_grad_and_decode_are_finite(arch):
    """`tests/test_arch_smoke.py` test_forward_and_grad / test_decode_step
    on the port, in the config's own dtype."""
    cfg = treg.smoke_config(arch)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    _, batch = _batch(rreg.smoke_config(arch), seed=0)
    loss, grads = tsteps.value_and_grad(cfg, params, batch)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g.float()).all())
               for g in tree_leaves(grads))
    if cfg.family == "encdec":
        return                               # test_encdec_decode
    cache = tt.make_cache(cfg, B, SEQ, "cpu")
    if cfg.family == "vlm":
        logits, new = tt.decode_step(
            cfg, params, cache, torch.zeros((B, 1, cfg.d_model)), 0,
            positions3=torch.zeros((3, B, 1), dtype=torch.int32))
    else:
        logits, new = tt.decode_step(cfg, params, cache,
                                     torch.zeros((B,), dtype=torch.int32), 0)
    assert logits.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert sorted(new) == sorted(cache)
    assert all(new[k].shape == cache[k].shape for k in cache)


def test_encdec_decode():
    cfg = treg.smoke_config("seamless_m4t_medium")
    params = tt.init_params(cfg, torch.Generator().manual_seed(2))
    _, batch = _batch(rreg.smoke_config("seamless_m4t_medium"), seed=2)
    _, (enc_out, _) = tt.forward(cfg, params, batch, collect_cache=True)
    cache = tt.make_cache(cfg, B, SEQ, "cpu")
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    for i in range(cfg.dec_layers):
        cross = params["dec"]["cross"]
        cache["xk"][i] = (enc_out @ cross["wk"][i].to(enc_out.dtype)).reshape(
            B, SEQ, kv, dh).detach()
        cache["xv"][i] = (enc_out @ cross["wv"][i].to(enc_out.dtype)).reshape(
            B, SEQ, kv, dh).detach()
    logits, _ = tt.decode_step(cfg, params, cache,
                               torch.zeros((B,), dtype=torch.int32), 0)
    assert logits.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


def _decode_all(cfg, params, tokens):
    cache = tt.make_cache(cfg, 1, tokens.shape[1], "cpu")
    outs = []
    for t in range(tokens.shape[1]):
        lg, cache = tt.decode_step(cfg, params, cache, tokens[:, t], t)
        outs.append(lg)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("arch,n_tok", [("mamba2_2p7b", 16),
                                        ("qwen3_0p6b", 8)])
def test_decode_matches_full_sequence(arch, n_tok):
    """SSM decode equals the chunked scan; GQA decode with its cache
    equals full attention (the reference's rtol = atol = 2e-2, bf16)."""
    cfg = treg.smoke_config(arch)
    if cfg.family == "ssm":
        cfg = dataclasses.replace(cfg, n_layers=1)
    params = tt.init_params(cfg, torch.Generator().manual_seed(3))
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, n_tok)), dtype=torch.int32)
    with torch.no_grad():
        full, _ = tt.forward(cfg, params, {"tokens": tokens})
        dec = _decode_all(cfg, params, tokens)
    np.testing.assert_allclose(full.float().numpy(), dec.float().numpy(),
                               rtol=2e-2, atol=2e-2)


DECODE_SEQ, DECODE_POS = 12, (5, 6, 7)


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-9, what


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_float32_decode_steps_match_reference(arch):
    """`decode_step` of both packages from one cache, in float32: a few
    positions, each side carrying its own new cache forward.  The cache
    starts random (so every earlier slot is read); enc-dec's cross K/V
    come from the reference's encoder output; vlm decodes embeddings at
    M-RoPE positions whose three rows differ.  Logits and every cache
    leaf within 1e-4 of the reference's largest entry."""
    rcfg, tcfg = _both(arch, dtype="float32")
    rng = np.random.default_rng(11)
    params = jax.jit(lambda k: rt.init_params(rcfg, k))(jax.random.PRNGKey(4))
    tparams = params_from_reference(jax.device_get(params), "cpu")
    shapes = jax.eval_shape(lambda: rt.make_cache(rcfg, B, DECODE_SEQ))
    cache = {k: (0.5 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in shapes.items()}
    if rcfg.family == "encdec":
        np_batch, _ = _batch(rcfg, seed=5, seq=DECODE_SEQ)
        _, (enc_out, _) = jax.jit(lambda p, b: rt.forward(
            rcfg, p, b, collect_cache=True))(params, np_batch)
        cross = jax.device_get(params)["dec"]["cross"]
        kv = (B, DECODE_SEQ, rcfg.n_kv_heads, rcfg.head_dim)
        enc_out = np.asarray(enc_out)
        cache["xk"] = np.stack([(enc_out @ w).reshape(kv)
                                for w in cross["wk"]])
        cache["xv"] = np.stack([(enc_out @ w).reshape(kv)
                                for w in cross["wv"]])
    rcache = {k: jnp.asarray(v) for k, v in cache.items()}
    tcache = {k: torch.as_tensor(v) for k, v in cache.items()}
    rstep = jax.jit(lambda p, c, tok, pos, p3: rt.decode_step(
        rcfg, p, c, tok, pos, positions3=p3))
    for pos in DECODE_POS:
        if rcfg.family == "vlm":
            tok = rng.normal(size=(B, 1, rcfg.d_model)).astype(np.float32)
            pos3 = (pos + rng.integers(0, 3, (3, B, 1))).astype(np.int32)
        else:
            tok = rng.integers(0, rcfg.vocab, (B,)).astype(np.int32)
            pos3 = None
        rlogits, rcache = rstep(params, rcache, tok, np.int32(pos), pos3)
        with torch.no_grad():
            logits, tcache = tt.decode_step(
                tcfg, tparams, tcache, torch.as_tensor(tok), pos,
                positions3=None if pos3 is None else torch.as_tensor(pos3))
        _close(logits, rlogits, (pos, "logits"))
        assert sorted(tcache) == sorted(rcache)
        for k in rcache:
            _close(tcache[k], rcache[k], (pos, k))


@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_decode_matches_full_attention_and_reference(absorbed):
    """MLA decode (the W_uk-absorbed query and the re-expanded K / V)
    step by step against the full causal `mla_attention` over the
    sequence, its compressed cache against the full pass's, and each
    step against the reference's `mla_decode`; float32, within 1e-4 of
    the largest entry."""
    from repro.models import attention as rattn

    rcfg, tcfg = _both("deepseek_v2_lite_16b", dtype="float32")
    p = jax.device_get(rattn.init_mla(jax.random.PRNGKey(7), rcfg))
    tp = params_from_reference(p, "cpu")
    n = 6
    x = np.random.default_rng(7).normal(
        size=(B, n, rcfg.d_model)).astype(np.float32)
    tx = torch.as_tensor(x)
    positions = torch.arange(n)[None].expand(B, n)
    with torch.no_grad():
        full, (ckv_full, kpe_full) = tattn.mla_attention(tp, tx, tcfg,
                                                         positions)
    ckv = torch.zeros((B, n, rcfg.kv_lora_rank))
    kpe = torch.zeros((B, n, rcfg.qk_rope_dim))
    rckv, rkpe = jnp.asarray(ckv.numpy()), jnp.asarray(kpe.numpy())
    for t in range(n):
        with torch.no_grad():
            out, ckv, kpe = tattn.mla_decode(tp, tx[:, t:t + 1], tcfg, ckv,
                                             kpe, t, absorbed=absorbed)
        rout, rckv, rkpe = rattn.mla_decode(p, jnp.asarray(x[:, t:t + 1]),
                                            rcfg, rckv, rkpe, t,
                                            absorbed=absorbed)
        _close(out, full[:, t:t + 1].numpy(), (t, "full"))
        _close(out, rout, (t, "reference"))
        _close(ckv, rckv, (t, "ckv"))
        _close(kpe, rkpe, (t, "kpe"))
    _close(ckv, ckv_full.numpy(), "ckv vs full")
    _close(kpe, kpe_full.numpy(), "kpe vs full")


def test_moe_layer_with_capacity_overflow_matches_reference():
    """One MoE layer where experts overflow their capacity (so the
    stable sort decides which assignments drop), on router inputs whose
    top-k has no ties."""
    rcfg, tcfg = _both("grok1_314b", dtype="float32", capacity_factor=0.5)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 32, rcfg.d_model)).astype(np.float32)
    p = jax.device_get(rmoe.init_moe(jax.random.PRNGKey(8), rcfg))
    probs = jax.nn.softmax(x.reshape(-1, rcfg.d_model) @ p["router"], -1)
    top = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    assert (np.diff(-top[:, :rcfg.top_k + 1], axis=-1) > 1e-6).all()
    ref = np.asarray(rmoe.moe_ffn(p, jnp.asarray(x), rcfg))
    got = tmoe.moe_ffn(params_from_reference(p, "cpu"), torch.as_tensor(x),
                       tcfg).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    n, cap = 64, 16                               # max(8, 0.5 * 64 * 2 / 4)
    idx = np.argsort(-np.asarray(probs), axis=-1)[:, :rcfg.top_k]
    assert np.bincount(idx.ravel(), minlength=4).max() > cap < n


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_dense_attention(causal):
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    got = tblock.blockwise_attention(tq, tk, tv, causal=causal, q_chunk=16,
                                     kv_chunk=8)
    cfg = treg.smoke_config("qwen3_0p6b")
    scores = tattn._gqa_scores(tq, tk, cfg)
    if causal:
        mask = torch.tril(torch.ones((64, 64), dtype=torch.bool))
        scores = torch.where(mask[None, None, None], scores, tattn.NEG_INF)
    dense = tattn._gqa_out(torch.softmax(scores, -1), tv).reshape(got.shape)
    assert float((got - dense).abs().max()) < 1e-5
    ref = np.asarray(rblock.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=16, kv_chunk=8))
    assert np.abs(got.numpy() - ref).max() < 1e-5
