"""DLRM's top MLP (`dlrm-top-mlp-criteo1tb`, widths 479-1024-1024-512-
256-1): the configuration, its layer graph at the real widths (graph
only: 3 / 4 / 1 shape buckets, a 2^28 merged opening), and at a tiny
pyramid of the same shape the port's SGD step against the plain
reference (`zkbench/reference/sgd.py`), a proof verified from bytes
whose openings equal the reference's own tensors, and the trainer's
opt-in flags.  The card runs the real widths' products in the ``gpu``
test."""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.pipeline import (api, build_fcnn_graph, proofio,
                                       verifier)
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.profile import proof_counts
from repro_torch.core.pipeline.session import ProofSession
from repro_torch.core.quantfc import (QuantConfig, quantize, sgd_apply,
                                      train_step_witness)
from zkbench.reference import proofcheck, sgd
from zkbench.work.geometry import Geometry

DLRM = (479, 1024, 1024, 512, 256, 1)
TINY = (7, 16, 16, 8, 4, 1)
LABEL = b"zkdl/train"
QC = QuantConfig(16, 8)


def test_the_configuration():
    cfg = registry.get_config("dlrm-top-mlp-criteo1tb")
    assert cfg == registry.get_config("dlrm_top_mlp_criteo1tb")
    assert (cfg.family, cfg.n_layers, cfg.widths) == ("fcnn", 5, DLRM)
    smoke = registry.smoke_config("dlrm-top-mlp-criteo1tb")
    assert (smoke.n_layers, smoke.widths) == (5, TINY)
    # the reference's list stays the reference's
    assert "dlrm_top_mlp_criteo1tb" not in registry.ARCHS
    assert registry.get_config("fcnn-zkdl-16l").widths == ()


def test_buckets_and_counts_at_the_real_widths():
    cfg = PipelineConfig.from_graph(build_fcnn_graph(DLRM, 512), 16, 8, 1)
    buckets = cfg.graph.buckets
    assert [len(buckets[f]) for f in ("fwd", "bwd", "gw")] == [3, 4, 1]
    assert [b.inner for b in buckets["bwd"]] == [1024, 512, 256, 1]
    assert cfg.merged_len == 1 << 28
    assert proof_counts(cfg) == {
        "buckets": 8, "aux_real": 512 * 2817, "aux_stacked": 8 * 512 * 1024,
        "validity_positions": 2 * (1 << 22) * 24}


@pytest.mark.parametrize("widths,batch,steps", [
    (DLRM, 512, 1), (DLRM, 1024, 1), (TINY, 8, 1), (TINY, 8, 3),
    ((4096, 4096, 4096), 128, 1)])
def test_merged_length_equals_the_benchmark_geometry(widths, batch, steps):
    cfg = PipelineConfig.from_graph(build_fcnn_graph(widths, batch),
                                    16, 8, steps)
    geo = Geometry(widths, batch, steps)
    assert cfg.merged_len == geo.merged_len
    assert (cfg.d_stack, cfg.w_stack, cfg.agg_len) == (
        geo.d_stack, geo.w_stack, geo.agg_len)
    assert proof_counts(cfg)["validity_positions"] == (
        geo.validity_main + geo.validity_rem)


@pytest.fixture(scope="module")
def tiny_window():
    """One step of the tiny pyramid, batch 8, 0/1 labels, weights by
    fan-in: the port's witness and update, the reference's, and the
    port's proof as bytes."""
    rng = np.random.default_rng(23)
    ws = [quantize(rng.uniform(-1, 1, (TINY[l], TINY[l + 1]))
                   * (2 / TINY[l] ** 0.5), QC) for l in range(5)]
    x = quantize(rng.uniform(-1, 1, (8, TINY[0])), QC)
    y = (rng.uniform(0, 1, (8, 1)) < 0.25).astype(np.int64) << 8
    wit = train_step_witness(x, y, ws, QC, device="cpu")
    new = sgd_apply(wit.w, wit.gw, 16, QC)
    ref_ws, ref_tensors = sgd.sgd_step(
        [torch.as_tensor(w) for w in ws], torch.as_tensor(x),
        torch.as_tensor(y), 16, 8, 16)
    pk, vk = api.compile(build_fcnn_graph(TINY, 8), QC, n_steps=1,
                         device="cpu")
    session = ProofSession(pk, np.random.default_rng(5), label=LABEL)
    session.add_step(wit)
    raw = proofio.encode_proof(session.prove())
    return {"wit": wit, "new": new, "ref_ws": ref_ws, "ref": ref_tensors,
            "vk": vk.to_bytes(), "raw": raw,
            "profile": session.last_profile.as_dict()}


def test_sgd_step_equals_the_reference(tiny_window):
    w, ref = tiny_window["wit"], tiny_window["ref"]
    for l in range(5):
        assert torch.equal(torch.as_tensor(tiny_window["new"][l]),
                           tiny_window["ref_ws"][l])
        assert torch.equal(w.zpp[l], ref["zpp"][l])
        assert torch.equal(w.b[l], ref["bq"][l])
        assert torch.equal(w.rz[l], ref["rz"][l])
        assert torch.equal(w.gw[l], ref["gw"][l])
    for l in range(4):
        assert torch.equal(w.gap[l], ref["gap"][l])
        assert torch.equal(w.rga[l], ref["rga"][l])


def test_proof_verifies_from_bytes_with_the_reference_openings(tiny_window):
    raw = tiny_window["raw"]
    vkey = proofio.decode_vk(tiny_window["vk"], device="cpu")
    assert verifier.verify_bytes(vkey, raw, label=LABEL)
    geo = Geometry(TINY, 8, 1)
    assert proofcheck.check_proof(raw, geo, [tiny_window["ref"]],
                                  LABEL) == []
    # a G_W entry off by one is caught by the reference's openings
    bad = {k: [t.clone() if t is not None else None for t in v]
           for k, v in tiny_window["ref"].items()}
    bad["gw"][4][0, 3] += 1
    assert proofcheck.check_proof(raw, geo, [bad], LABEL) == ["a6"]


def test_profile_splits_matmul_and_counts(tiny_window):
    prof = tiny_window["profile"]
    sub = prof["sub_phases_s"]
    fams = [sub[f"sumcheck-{f}"] for f in ("fwd", "bwd", "gw")]
    assert all(s > 0 for s in fams)
    assert sum(fams) <= prof["phases_s"]["matmul"]
    # 8 x (16 + 16 + 8 + 4 + 1) real of 8 slots x 8 x 16
    assert prof["counts"] == {"buckets": 8, "aux_real": 360,
                              "aux_stacked": 1024,
                              "validity_positions": 2 * 1024 * 24}


def test_trainer_runs_the_config_widths(monkeypatch, capsys):
    """``--arch dlrm-top-mlp-criteo1tb`` trains and proves at the
    config's own widths (here the smoke config's), with the opt-in
    fan-in init and SGD step."""
    from repro_torch.launch import train

    monkeypatch.setattr(registry, "get_config",
                        lambda name: registry.smoke_config(name))
    argv = ["--device", "cpu", "--arch", "dlrm-top-mlp-criteo1tb",
            "--global-batch", "2", "--steps", "1", "--prove-window", "1",
            "--init", "fan-in", "--lr-shift", "16"]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "7x16x16x8x4x1, batch 2" in out
    assert out.count("verified=True") == 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,layout", [
    (512, 479, 1024, "rows"),          # Z^1 = X W^1, K off the K tile
    (512, 256, 1, "rows"),             # Z^5: N = 1
    (512, 1, 256, "b_T"),              # G_A^4 = G_Z^5 W^{5,T}: K = 1
    (1, 512, 256, "a_T"),              # G_W^5 = G_Z^{5,T} A^4: M = 1
    (1024, 512, 479, "a_T")])          # G_W^1 = G_Z^{1,T} X
def test_qmatmul_at_the_real_shapes(m, k, n, layout):
    """The card's fused kernel against the plain version on CPU copies
    at the DLRM products no other cell runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import qmatmul as qk

    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-2**15, 2**15, (m, k), generator=gen,
                      dtype=torch.int16)
    b = torch.randint(-2**15, 2**15, (k, n), generator=gen,
                      dtype=torch.int16)
    da, db = a.cuda(), b.cuda()
    if layout == "a_T":
        da = da.T.contiguous().T
    if layout == "b_T":
        db = db.T.contiguous().T
    assert torch.equal(qk.qmatmul_i64(da, db).cpu(), qk.qmatmul_i64(a, b))
