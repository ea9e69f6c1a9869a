"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test skips itself.  This
file imports neither jax nor the reference, so it runs on a machine
with only PyTorch and the CUDA toolkit (``--noconftest`` skips the
suite's conftest, which imports jax):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.field import FP, FQ, encode_int
from repro_torch.kernels import generators as gk
from repro_torch.kernels import modmul as mk
from repro_torch.kernels import qmatmul as qk
from repro_torch.kernels import sumcheck_fold as fk
from repro_torch.kernels import validity_tables as vk

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(spec, n, seed, dev):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, spec.modulus, n, dtype=np.uint64) % spec.modulus
    t = torch.as_tensor(v.astype(np.int64), device=dev)
    t[:3] = torch.tensor([0, 1, spec.modulus - 1], device=dev)
    return t


@pytest.mark.parametrize("spec", [FQ, FP], ids=["Fq", "Fp"])
def test_modmul_kernel_matches_plain(dev, spec):
    a, b = _field(spec, 4099, 1, dev), _field(spec, 4099, 2, dev)
    before = kernels.launch_counts()["modmul"]
    assert torch.equal(mk.modmul(spec, a, b), mk.modmul_plain(spec, a, b))
    assert torch.equal(mk.modmul(spec, a, 77), mk.modmul_plain(spec, a, 77))
    assert torch.equal(mk.modmul(spec, a[:, None], b[None, :5]),
                       mk.modmul_plain(spec, a[:, None], b[None, :5]))
    assert kernels.launch_counts()["modmul"] == before + 3


def test_fold_kernels_match_plain(dev):
    x = _field(FQ, 1 << 12, 3, dev)
    r, c = encode_int(FQ, 12345), encode_int(FQ, 678)
    assert torch.equal(fk.fold(x, r), fk.fold_plain(x, r))
    assert torch.equal(fk.fold(x, r, inner=64), fk.fold_plain(x, r, 64))
    assert torch.equal(fk.fold_halves(x, r, c), fk.fold_halves_plain(x, r, c))


def test_validity_tables_kernel_matches_plain(dev):
    rng = np.random.default_rng(4)
    ds, qb, rb = 64, 16, 8
    lim = 1 << (qb - 1)
    aux = [rng.integers(0, lim, ds), rng.integers(-lim, lim, ds),
           rng.integers(0, 2, ds), rng.integers(0, 1 << rb, ds),
           rng.integers(0, 1 << rb, ds)]
    layout = vk.build_layout(*[torch.as_tensor(a, device=dev) for a in aux],
                             qb, rb)
    n = layout.vals.shape[0]
    ef, es = _field(FQ, n, 5, dev), _field(FQ, n, 6, dev)
    got = vk.build_tables(layout, 7, 8, 9, ef, es)
    want = vk.build_tables_plain(layout, 7, 8, 9, ef, es)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_generator_kernel_matches_hashlib(dev):
    for label in (b"zkdl/gens/agg", b"x" * gk.MAX_LABEL_BYTES):
        assert torch.equal(gk.derive(label, 3, 500, dev),
                           gk.derive_plain(label, 3, 500, dev))


@pytest.mark.parametrize("e_lo,e_hi", [(1, 0x0BADC0FFEE12345),
                                       ((1 << 61) - 1, 1 << 60),
                                       (0, 987654321)])
def test_pow_mul_kernel_matches_plain(dev, e_lo, e_hi):
    gens = _field(FP, 2 * 1027, 7, dev)
    before = kernels.launch_counts()["pow_mul"]
    assert torch.equal(fk.pow_mul_halves(gens, e_lo, e_hi),
                       fk.pow_mul_plain(gens, e_lo, e_hi))
    assert kernels.launch_counts()["pow_mul"] == before + 1


def _int16_pair(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-2 ** 15, 2 ** 15, (m, k))
    b = rng.integers(-2 ** 15, 2 ** 15, (k, n))
    a.flat[:2] = [-2 ** 15, 2 ** 15 - 1]         # the int16 edges
    b.flat[:2] = [2 ** 15 - 1, -2 ** 15]
    return (torch.as_tensor(a).to(torch.int16),
            torch.as_tensor(b).to(torch.int16))


def _on_card(x, dev, transposed):
    """x on the card, row-major or as the .T view of a row-major tensor."""
    x = x.to(dev)
    return x.T.contiguous().T if transposed else x


@pytest.mark.parametrize("layout", ["rows", "a_T", "b_T", "both_T"])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 300, 50),
                                   (128, 256, 192), (70, 1, 66),
                                   (2, qk.K_MAX, 3)])
def test_qmatmul_kernel_matches_plain(dev, m, k, n, layout):
    """The fused kernel against the plain version on CPU copies (CUDA
    has no integer matmul): ragged edges, K = 1, K off the K tile and the
    largest accepted K, with operands as row-major tensors or .T views;
    one launch per qmatmul_i64."""
    a, b = _int16_pair(m, k, n, m + k + n)
    da = _on_card(a, dev, layout in ("a_T", "both_T"))
    db = _on_card(b, dev, layout in ("b_T", "both_T"))
    before = kernels.launch_counts()["qmatmul"]
    got = qk.qmatmul_i64(da, db)
    assert kernels.launch_counts()["qmatmul"] == before + 1
    assert torch.equal(got.cpu(), qk.qmatmul_i64(a, b))


@pytest.mark.parametrize("fill", [-2 ** 15, 2 ** 15 - 1])
def test_qmatmul_kernel_exact_at_int16_extremes(dev, fill):
    """Every entry at an int16 extreme, up to the largest accepted K,
    where one int32 digit product reaches 2^31."""
    for m, k, n in [(65, 200, 67), (1, qk.K_MAX, 1)]:
        a = torch.full((m, k), -2 ** 15, dtype=torch.int16)
        b = torch.full((k, n), fill, dtype=torch.int16)
        want = torch.full((m, n), -2 ** 15 * fill * k, dtype=torch.int64)
        assert torch.equal(qk.qmatmul_i64(a.to(dev), b.to(dev)).cpu(), want)


def test_scbd_on_card_gives_golden_digest(dev):
    """SC-BD's wiring tables built and summed on the card: the proof of
    the audit-domain golden tensor hashes to the reference's digest
    (tests/test_scbd.py), and a forged claim is rejected."""
    from repro_torch.core import scbd
    from repro_torch.core.transcript import Transcript

    aux = torch.as_tensor(((np.arange(16) * 37) % 256) - 128, device=dev)
    before = kernels.launch_counts()
    proof = scbd.prove(aux, 8, Transcript(b"zkdl/scbd-audit"))
    after = kernels.launch_counts()
    assert proof.digest() == ("4b741340fd0f64f4c567b06911049dac"
                              "8e71a23d0b02a47751fa430823ece455")
    assert scbd.verify(proof, 16, 8, Transcript(b"zkdl/scbd-audit"))
    proof.claim = (proof.claim + 1) % scbd.Q_MOD
    assert not scbd.verify(proof, 16, 8, Transcript(b"zkdl/scbd-audit"))
    assert after["fold"] > before["fold"]
    assert after["modmul"] > before["modmul"]


def test_fresh_process_builds_no_kernel(dev):
    """After this process built every kernel, a fresh interpreter that
    launches one reports no compile and no write (execache.stats)."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.kernels import _build

    _build.build_all()
    code = ("import json, torch; from repro_torch.core import execache; "
            "from repro_torch.field import FQ; "
            "from repro_torch.kernels import modmul as mk; "
            "a = torch.arange(1, 9, device='cuda'); "
            "mk.modmul(FQ, mk.modmul(FQ, a, a), a); "
            "torch.cuda.synchronize(); print(json.dumps(execache.stats()))")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    res = subprocess.run([sys.executable, "-c", code], check=True,
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=300)
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["misses"] == 0 and stats["disk_writes"] == 0, stats
    assert stats["disk_hits"] == len(_build.SOURCES) and stats["hits"] == 1


def _small_witness(dev, seed=3):
    from repro_torch.core.quantfc import (QuantConfig,
                                          synthetic_sgd_trajectory_widths)
    return synthetic_sgd_trajectory_widths(1, (4, 4, 4), 2,
                                           QuantConfig(16, 4), seed=seed,
                                           device=dev)[0]


def test_journal_round_trip_of_card_tensors(dev, tmp_path):
    """A witness on the card journals to the host npz layout and loads
    back onto the card tensor-equal (and onto the CPU the same)."""
    from repro_torch.launch import serve

    wit = _small_witness(dev)
    serve.journal_append(str(tmp_path), 0, wit)
    back = serve.journal_load(str(tmp_path), 0, dev)
    host = serve.journal_load(str(tmp_path), 0, "cpu")
    assert back.x.is_cuda and not host.x.is_cuda
    for name in ("x", "y"):
        assert torch.equal(getattr(back, name), getattr(wit, name))
    for name in serve._WIT_LISTS:
        for got, cpu, want in zip(getattr(back, name), getattr(host, name),
                                  getattr(wit, name)):
            assert got.is_cuda and torch.equal(got, want)
            assert torch.equal(cpu, want.cpu())


def test_preflight_on_card_tensors(dev):
    """`validate_witness` checks a card witness on the card, and rejects a
    broken eq. (3) decomposition with the reference's message."""
    import dataclasses

    from repro_torch.core.pipeline import build_fcnn_graph
    from repro_torch.core.pipeline.config import PipelineConfig
    from repro_torch.launch.preflight import (WitnessRangeError,
                                              validate_witness)

    cfg = PipelineConfig.from_graph(build_fcnn_graph((4, 4, 4), 2),
                                    q_bits=16, r_bits=4, n_steps=1)
    wit = _small_witness(dev)
    assert validate_witness(cfg, wit) is None
    z0 = wit.z[0].clone()
    z0[0, 0] += 1
    bad = dataclasses.replace(wit, z=[z0] + list(wit.z[1:]))
    with pytest.raises(WitnessRangeError, match="eq. 3"):
        validate_witness(cfg, bad)


def test_corrupt_cache_entry_is_rebuilt(dev):
    """The ``corrupt-cache`` fault truncates a built library (by rename,
    so this process keeps its mapping); a fresh process counts it
    (disk_corrupt), deletes it, rebuilds it, and its kernel runs."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.kernels import _build
    from repro_torch.train.resilience import corrupt_exec_cache_entry

    _build.build_all()
    path = corrupt_exec_cache_entry()
    assert path is not None and path.endswith(".so")
    name = os.path.basename(path).split("-")[0]
    code = ("import json, torch; from repro_torch.core import execache; "
            "from repro_torch.kernels import _build; _build.build_all(); "
            "print(json.dumps(execache.stats()))")
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    res = subprocess.run([sys.executable, "-c", code], check=True,
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=600)
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["disk_corrupt"] == 1 and stats["misses"] == 1, stats
    assert stats["disk_hits"] == len(_build.SOURCES) - 1, stats
    assert os.path.getsize(path) > 0 and name in _build.SOURCES
    a, b = _field(FQ, 257, 5, dev), _field(FQ, 257, 6, dev)
    assert torch.equal(mk.modmul(FQ, a, b), mk.modmul_plain(FQ, a, b))


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "mamba2_2p7b",
                                  "deepseek_v2_lite_16b"])
def test_smoke_forward_on_card_matches_cpu(dev, arch):
    """One float32 forward and loss of a smoke config on the card and on
    the CPU from the same parameters (matmuls in full float32)."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import transformer as tt
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    batch = SyntheticTokens(cfg, 32, 2, seed=1).batch(0)
    cpu = {k: torch.as_tensor(v) for k, v in batch.items()}
    card = {k: v.to(dev) for k, v in cpu.items()}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want, _ = tt.forward(cfg, params, cpu)
            got, _ = tt.forward(cfg, tree_map(lambda p: p.to(dev),
                                                 params), card)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert float((got.cpu() - want).abs().max()) <= \
        1e-4 * float(want.abs().max())


def test_lm_trainer_restart_on_card(dev, tmp_path, monkeypatch):
    """A --fail-at run of the smoke trainer on the card resumes after its
    last checkpoint with the uninterrupted run's losses, bit for bit
    under deterministic algorithms."""
    import json
    import os

    from repro_torch.configs import registry
    from repro_torch.launch import train

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(registry, "get_config",
                        lambda name, **kw: registry.smoke_config(name))
    base = ["--arch", "qwen3-0.6b", "--seq", "32",
            "--global-batch", "2", "--steps", "6", "--compress", "int8"]

    def run(name, extra):
        out = str(tmp_path / f"{name}.jsonl")
        assert train.main(base + ["--metrics-out", out] + extra) == 0
        with open(out) as f:
            return [json.loads(line) for line in f]

    torch.use_deterministic_algorithms(True)
    try:
        plain = run("plain", [])
        failed = run("failed", ["--ckpt-dir", str(tmp_path / "ck"),
                                "--ckpt-every", "2", "--fail-at", "3"])
    finally:
        torch.use_deterministic_algorithms(False)
    assert [r["step"] for r in failed] == list(range(6))
    assert [r["loss"] for r in failed] == [r["loss"] for r in plain]


@pytest.mark.parametrize("arch", ["grok1_314b", "deepseek_v2_lite_16b"])
def test_moe_forward_on_a_1x1_mesh_equals_plain(dev, arch):
    """The moe smoke config's forward with DTensor parameters on a 1x1
    DeviceMesh (an NCCL world of one; the MoE local_map dispatch and
    combine) equals the plain forward on the card."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed import hints, sharding
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tt

    cfg = dataclasses.replace(registry.smoke_config(arch), dtype="float32")
    params = tt.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             SyntheticTokens(cfg, 32, 2, seed=1).batch(0).items()}
    mesh, _, started = train.start_mesh("1x1", dev)
    try:
        with torch.no_grad():
            plain, _ = tt.forward(cfg, params, batch)
            steps.set_mesh_hints(mesh)
            dp = steps.place(params, sharding.param_shardings(cfg, mesh,
                                                              params))
            db = steps.place(batch, sharding.batch_shardings(cfg, mesh,
                                                             batch))
            with implicit_replication():
                got, _ = tt.forward(cfg, dp, db)
        got = got.full_tensor()
    finally:
        hints.clear()
        if started:
            dist.destroy_process_group()
    assert float((got - plain).abs().max()) <= \
        1e-6 * float(plain.abs().max())
