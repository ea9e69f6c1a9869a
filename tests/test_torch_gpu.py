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


# -- the msm kernel against the torch-op Pippenger on the same tensors ------

_EDGE_EXPS = [0, 1, FQ.modulus - 1, (1 << 61) - 1]


def _exps(shape, seed, dev, nbits=61):
    """Standard-form exponents below 2^nbits, the first four the edges
    0, 1, q - 1 and 2^61 - 1 (cut to nbits)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, FQ.modulus, shape, dtype=np.uint64) % FQ.modulus
    e = torch.as_tensor(e.astype(np.int64)).reshape(-1)
    k = min(4, e.numel())
    e[:k] = torch.tensor(_EDGE_EXPS[:k])
    e &= (1 << nbits) - 1
    return e.reshape(shape).to(dev)


def _points(n, dev, label=b"zkdl/msm-test"):
    from repro_torch.core import group
    return group.derive_generators(label, n, dev)


def _msm_launches():
    return kernels.launch_counts()["msm"]


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("nbits", [61, 17])
def test_msm_kernel_one_row_matches_pippenger(dev, n, nbits):
    from repro_torch.core import group
    from repro_torch.kernels import msm as km
    pts, e = _points(n, dev), _exps((1, n), n, dev, nbits)
    before = _msm_launches()
    got = group.msm_many(pts, e, nbits=nbits)
    assert _msm_launches() > before
    assert torch.equal(got, group.msm_many_plain(pts, e, nbits=nbits))
    assert torch.equal(got, km.msm_plain([(pts, e)], nbits))


@pytest.mark.parametrize("rows", [2, 64])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "own"])
def test_msm_kernel_rows_match_pippenger(dev, rows, shared):
    from repro_torch.core import group
    n = 1000
    e = _exps((rows, n), rows, dev)
    pts = _points(n if shared else rows * n, dev)
    if not shared:
        pts = pts.view(rows, n)
    assert torch.equal(group.msm_many(pts, e),
                       group.msm_many_plain(pts, e))


def test_msm_kernel_ragged_rows_like_commit_many(dev):
    """Rows laid out as `commit_many` lays them out (values, then a
    one-term blind tail), plus a row with no terms and a blind-only
    row."""
    from repro_torch.core import group, pedersen
    key = pedersen.make_key(b"msm-test", 5000, dev)
    lens = [4097, 0, 1, 33, 0]
    pts, exps, ids = [], [], []
    for r, n in enumerate(lens):
        if r == 1:
            continue                    # row 1 has no terms at all
        pts += [key.gens[:n], key.h.reshape(1)]
        exps += [_exps((n,), r, dev), _exps((1,), 100 + r, dev)]
        ids.append(torch.full((n + 1,), r, dtype=torch.int64, device=dev))
    pts, exps, ids = torch.cat(pts), torch.cat(exps), torch.cat(ids)
    before = _msm_launches()
    got = group.msm_ragged(pts, exps, ids, len(lens))
    assert _msm_launches() > before
    assert torch.equal(got, group.msm_ragged_plain(pts, exps, ids,
                                                   len(lens)))
    assert int(got[1]) == group.identity(dev).item()


@pytest.mark.parametrize("n2", [1, 300, 1 << 17])
def test_msm_kernel_segments_match_concatenated_rows(dev, n2):
    """Two and three segments read in place (halves in either order, a
    shared two-point tail) against the rows concatenated."""
    from repro_torch.core import group
    g, h = _points(2 * n2, dev, b"msm-g"), _points(2 * n2, dev, b"msm-h")
    ea, eb = _exps((2 * n2,), 1, dev), _exps((2 * n2,), 2, dev)
    tail = (_points(2, dev, b"msm-t"), _exps((2, 2), 3, dev))
    two = [([g[n2:], g[:n2]], [ea[:n2], ea[n2:]]),
           ([h[:n2], h[n2:]], [eb[n2:], eb[:n2]])]
    rows = [(torch.cat([g[n2:], h[:n2]]), torch.cat([ea[:n2], eb[n2:]])),
            (torch.cat([g[:n2], h[n2:]]), torch.cat([ea[n2:], eb[:n2]]))]
    want2 = torch.stack([group.msm_many_plain(p, e[None])[0]
                         for p, e in rows])
    assert torch.equal(group.msm_segments(two), want2)
    want3 = torch.stack([
        group.msm_many_plain(torch.cat([p, tail[0]]),
                             torch.cat([e, tail[1][i]])[None])[0]
        for i, (p, e) in enumerate(rows)])
    assert torch.equal(group.msm_segments(two + [tail]), want3)


def test_prove_on_card_gives_golden_bytes_through_msm_kernel(dev,
                                                             monkeypatch):
    """The uniform 2x4 MLP (QuantConfig(16, 4), seed 7, T = 1) proved on
    the card hashes to the reference's recorded digest and verifies from
    bytes, with every MSM in the kernel: the torch-op Pippenger is made
    to fail if anything calls it."""
    import hashlib

    from repro_torch.core import group
    from repro_torch.core.pipeline import (GraphBuilder, compile,
                                           encode_proof, prove_session,
                                           verify_bytes)
    from repro_torch.core.quantfc import QuantConfig, synthetic_sgd_trajectory

    def refuse(*args, **kwargs):
        raise AssertionError("the torch-op MSM ran on the card")
    for name in ("msm_many_plain", "msm_ragged_plain", "_pippenger",
                 "_segment_products"):
        monkeypatch.setattr(group, name, refuse)
    qc = QuantConfig(16, 4)
    graph = GraphBuilder(batch=2).input(4).dense(4).relu().dense(4).relu() \
        .output()
    pk, vk = compile(graph, qc, n_steps=1, device=dev)
    wits = synthetic_sgd_trajectory(1, 2, 2, 4, qc, seed=7, device=dev)
    kernels.reset_launch_counts()
    raw = encode_proof(prove_session(pk, wits, np.random.default_rng(7)))
    assert _msm_launches() > 0
    assert hashlib.sha256(raw).hexdigest() == (
        "a538160f1da619bd39439420f78d24af9089dd1eacd770f3ce24d76dd80c2422")
    before = _msm_launches()
    assert verify_bytes(vk, raw)
    assert _msm_launches() > before


#: exponent edges of the powmod tests: 0, 1, 2, q - 1 and 2^61 - 1
_POW_EDGES = [0, 1, 2, FQ.modulus - 1, (1 << 61) - 1]


def _pow_inputs(spec, n, seed, dev):
    """n canonical bases (0, one and m - 1 first) and n exponents laid out
    like the merged IPA's w: a run of ones, random words below q with the
    edge exponents at their head, a run of ones."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, spec.modulus, n, dtype=np.uint64) % spec.modulus
    e = rng.integers(0, FQ.modulus, n, dtype=np.uint64) % FQ.modulus
    b, e = b.astype(np.int64), e.astype(np.int64)
    b[:3] = [0, spec.one, spec.modulus - 1][:n]
    run = n // 4
    e[:run], e[n - run:] = 1, 1
    k = min(len(_POW_EDGES), n - 2 * run)
    e[run:run + k] = _POW_EDGES[:k]
    return torch.as_tensor(b, device=dev), torch.as_tensor(e, device=dev)


def _powmod_launches():
    return kernels.launch_counts()["powmod"]


@pytest.mark.parametrize("nbits", [1, 17, 61, 63])
@pytest.mark.parametrize("n", [0, 1, 33, (1 << 20) + 3])
@pytest.mark.parametrize("spec", [FQ, FP], ids=["Fq", "Fp"])
def test_powmod_kernel_matches_plain(dev, spec, n, nbits):
    from repro_torch.kernels import powmod as pk
    b, e = _pow_inputs(spec, n, n + nbits, dev)
    if nbits == 63:
        e[n // 2:] |= 1 << 62             # words past 61 bits, all 63 used
    before = _powmod_launches()
    got = pk.powmod(spec, b, e, nbits)
    assert _powmod_launches() == before + 1
    assert torch.equal(got, pk.powmod_plain(spec, b, e, nbits))


@pytest.mark.parametrize("spec", [FQ, FP], ids=["Fq", "Fp"])
def test_powmod_kernel_broadcasts_and_scalar_exponents(dev, spec):
    """A 0-dim base against a vector, a vector against a 0-dim exponent,
    and `pow_const` (the exponent by value) with 0, 1 and m - 2 on a
    0-dim tensor and on a vector: one launch each, equal to the plain
    version."""
    from repro_torch.field import pow_const
    from repro_torch.kernels import powmod as pk
    b, e = _pow_inputs(spec, 4099, 5, dev)
    cases = [(b[5], e), (b, e[3 * 4099 // 4 - 1]), (b[:1], e),
             (b[:, None][:8], e[None, :8])]
    before = _powmod_launches()
    for base, exp in cases:
        assert torch.equal(pk.powmod(spec, base, exp, 61),
                           pk.powmod_plain(spec, base, exp, 61))
    for c in (0, 1, spec.modulus - 2):
        for base in (b[7], b):
            assert torch.equal(pow_const(spec, base, c),
                               pk.powmod_plain(spec, base, c))
    assert _powmod_launches() == before + len(cases) + 6


@pytest.mark.parametrize("with_zero", [False, True])
def test_batch_inv_on_card(dev, with_zero):
    """Inverses equal python-int inverses in one powmod launch; one zero
    entry zeroes the whole output, as on the CPU."""
    from repro_torch.field import batch_inv, decode
    a = _field(FQ, 1000, 9, dev)[3:].clone()
    if with_zero:
        a[17] = 0
    before = _powmod_launches()
    got = batch_inv(FQ, a)
    assert _powmod_launches() == before + 1
    assert torch.equal(got, batch_inv(FQ, a.cpu()).to(dev))
    q = FQ.modulus
    vals = decode(FQ, a)
    want = [0] * len(vals) if with_zero else [pow(int(v), q - 2, q)
                                              for v in vals]
    assert list(decode(FQ, got)) == want


def test_prove_on_card_gives_golden_bytes_through_powmod_kernel(
        dev, monkeypatch):
    """The uniform 2x4 MLP proved and verified on the card with every
    elementwise power in the powmod kernel: its torch-op loop is made to
    fail if anything calls it on a CUDA tensor."""
    import hashlib

    from repro_torch.core.pipeline import (GraphBuilder, compile,
                                           encode_proof, prove_session,
                                           verify_bytes)
    from repro_torch.core.quantfc import QuantConfig, synthetic_sgd_trajectory
    from repro_torch.kernels.powmod import ops as pops

    plain = pops.powmod_plain

    def refuse_on_card(spec, bases, *args, **kwargs):
        if bases.device.type == "cuda":
            raise AssertionError("the torch-op power loop ran on the card")
        return plain(spec, bases, *args, **kwargs)
    monkeypatch.setattr(pops, "powmod_plain", refuse_on_card)
    qc = QuantConfig(16, 4)
    graph = GraphBuilder(batch=2).input(4).dense(4).relu().dense(4).relu() \
        .output()
    pk, vk = compile(graph, qc, n_steps=1, device=dev)
    wits = synthetic_sgd_trajectory(1, 2, 2, 4, qc, seed=7, device=dev)
    kernels.reset_launch_counts()
    raw = encode_proof(prove_session(pk, wits, np.random.default_rng(7)))
    assert _powmod_launches() > 0
    assert hashlib.sha256(raw).hexdigest() == (
        "a538160f1da619bd39439420f78d24af9089dd1eacd770f3ce24d76dd80c2422")
    before = _powmod_launches()
    assert verify_bytes(vk, raw)
    assert _powmod_launches() > before


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
