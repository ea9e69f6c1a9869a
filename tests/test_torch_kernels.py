"""The port's kernel wrappers against the reference kernels.

On the CPU every wrapper runs its plain PyTorch version; here each plain
version is held, bit for bit, against the reference's oracle (`ref.py`)
and against the reference's Pallas kernel run in interpret mode (as
tests/test_kernels.py runs it).  The CUDA kernels themselves run only on
the card: tests/test_torch_gpu.py carries the ``gpu`` marker and skips
without one, and `python3 chip_smoke.py` holds every kernel against its
plain version at main-path sizes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.field import FP as RFP, FQ as RFQ
from repro.field import modarith as rmod
from repro.core import group as rgroup
from repro.core import ipa as ripa
from repro.core.pipeline import GraphBuilder as RBuilder
from repro.core.pipeline.config import (PipelineConfig as RConfig,
                                        make_keys as r_make_keys)
from repro.kernels.modmul import modmul as r_modmul
from repro.kernels.modmul.ref import modmul_ref
from repro.kernels.sumcheck_fold import fold as r_fold
from repro.kernels.sumcheck_fold import fold_halves as r_fold_halves
from repro.kernels.sumcheck_fold.ref import fold_ref
from repro.kernels import validity_tables as rvt

from repro_torch import kernels
from repro_torch.core.pipeline import GraphBuilder
from repro_torch.core.pipeline.config import PipelineConfig, make_keys
from repro_torch.field import FP, FQ
from repro_torch.interop import from_reference, to_limbs
from repro_torch.kernels import generators as gk
from repro_torch.kernels import modmul as mk
from repro_torch.kernels import sumcheck_fold as fk
from repro_torch.kernels import validity_tables as vk

RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True, scope="module")
def _reference_without_disk_executables():
    """Run the reference's wrapped programs through plain `jax.jit` here:
    its on-disk executable cache is keyed without the device count, so
    an entry written by a worker that imported benchmarks/perf.py (512
    forced host devices) fails to load in a one-device worker, and this
    file must neither read nor write such entries."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKDL_EXEC_MODE", "off")
        yield


def _rand(rspec, n):
    vals = [int(v) % rspec.modulus
            for v in RNG.integers(0, rspec.modulus, n, dtype=np.uint64)]
    vals[:3] = [0, 1, rspec.modulus - 1]
    limbs = rmod.encode_ints(rspec, np.array(vals, dtype=object))
    return limbs, from_reference(limbs, "cpu")


@pytest.mark.parametrize("specs", [(RFQ, FQ), (RFP, FP)], ids=["Fq", "Fp"])
def test_modmul_plain_matches_ref_and_pallas(specs):
    rspec, spec = specs
    (ra, ta), (rb, tb) = _rand(rspec, 256), _rand(rspec, 256)
    got = to_limbs(mk.modmul(spec, ta, tb))
    np.testing.assert_array_equal(got, np.asarray(modmul_ref(
        rspec, jnp.asarray(ra), jnp.asarray(rb))))
    np.testing.assert_array_equal(got, np.asarray(r_modmul(
        rspec, jnp.asarray(ra), jnp.asarray(rb), interpret=True)))


@pytest.mark.parametrize("inner", [1, 4])
def test_fold_plain_matches_ref_and_pallas(inner):
    ra, ta = _rand(RFQ, 256)
    r = rmod.encode_int(RFQ, 123456789)
    r_m = int(from_reference(r, "cpu"))
    if inner == 1:
        got = to_limbs(fk.fold(ta, r_m).reshape(-1))
        np.testing.assert_array_equal(got, np.asarray(fold_ref(
            jnp.asarray(ra), jnp.asarray(r))))
        np.testing.assert_array_equal(got, np.asarray(r_fold(
            jnp.asarray(ra), jnp.asarray(r), interpret=True)))
    else:
        # row fold of a (64, 4) matrix == the reference's row fold
        from repro.core.pipeline.tables import fix_rows as r_fix_rows
        from repro_torch.core.pipeline.tables import fix_rows
        pt = [11, 22, 33]
        want = np.asarray(r_fix_rows(jnp.asarray(ra).reshape(64, 4, 4), pt))
        np.testing.assert_array_equal(to_limbs(fix_rows(ta.reshape(64, 4),
                                                        pt)), want)


def test_fold_halves_plain_matches_pallas_and_jnp():
    ra, ta = _rand(RFQ, 256)
    lo = rmod.encode_int(RFQ, 31337)
    hi = rmod.encode_int(RFQ, 271828)
    got = to_limbs(fk.fold_halves(ta, int(from_reference(lo, "cpu")),
                                  int(from_reference(hi, "cpu"))))
    np.testing.assert_array_equal(got, np.asarray(ripa._fold_halves(
        jnp.asarray(ra), jnp.asarray(lo), jnp.asarray(hi))))
    np.testing.assert_array_equal(got, np.asarray(r_fold_halves(
        jnp.asarray(ra), jnp.asarray(lo), jnp.asarray(hi), interpret=True)))


@pytest.fixture(scope="module")
def validity_case():
    ds, qb, rb = 4, 8, 4
    lim = 1 << (qb - 1)
    aux = dict(zpp=RNG.integers(0, lim, ds), gap=RNG.integers(-lim, lim, ds),
               bq=RNG.integers(0, 2, ds), rz=RNG.integers(0, 1 << rb, ds),
               rga=RNG.integers(0, 1 << rb, ds))
    r_layout = rvt.build_layout(*aux.values(), qb, rb)
    t_layout = vk.build_layout(*[torch.as_tensor(v) for v in aux.values()],
                               qb, rb)
    n = r_layout.vals.shape[0]
    ef, tef = _rand(RFQ, n)
    es, tes = _rand(RFQ, n)
    return r_layout, t_layout, (ef, tef), (es, tes), (777, 4242, 99)


def test_validity_layout_matches_reference(validity_case):
    r_layout, t_layout, *_ = validity_case
    for name in ("vals", "shift", "kmask", "kpmask", "colmask", "region"):
        np.testing.assert_array_equal(getattr(t_layout, name).numpy(),
                                      getattr(r_layout, name).astype(np.int64))
    assert (t_layout.n_main, t_layout.n_rem) == (r_layout.n_main,
                                                 r_layout.n_rem)


def test_validity_tables_plain_matches_ref_and_pallas(validity_case):
    r_layout, t_layout, (ef, tef), (es, tes), (k, zm, zr) = validity_case
    a, b = vk.build_tables(t_layout, k, zm, zr, tef, tes)
    # python-int oracle
    ef_i = list(rmod.decode(RFQ, ef))
    es_i = list(rmod.decode(RFQ, es))
    a_ref, b_ref = rvt.tables_ref(r_layout, k, zm, zr, ef_i, es_i)
    assert list(rmod.decode(RFQ, to_limbs(a))) == a_ref
    assert list(rmod.decode(RFQ, to_limbs(b))) == b_ref
    # the Pallas kernel in interpret mode
    rvt.set_backend("pallas")
    try:
        pa, pb = rvt.build_tables(r_layout, k, zm, zr, jnp.asarray(ef),
                                  jnp.asarray(es), interpret=True)
    finally:
        rvt.set_backend(None)
    np.testing.assert_array_equal(to_limbs(a), np.asarray(pa))
    np.testing.assert_array_equal(to_limbs(b), np.asarray(pb))


def test_generators_match_reference_for_every_key_label():
    """make_keys at the 2x4 shape derives the same generator tables."""
    rgraph = RBuilder(batch=2).input(4).dense(4).relu().dense(4).relu() \
        .output()
    graph = GraphBuilder(batch=2).input(4).dense(4).relu().dense(4).relu() \
        .output()
    rkeys = r_make_keys(RConfig.from_graph(rgraph, 16, 4, 1))
    keys = make_keys(PipelineConfig.from_graph(graph, 16, 4, 1), "cpu")
    pairs = [(rkeys.k_agg.gens, keys.k_agg.gens),
             (rkeys.h_open, keys.h_open),
             (rkeys.g_merged, keys.g_merged), (rkeys.h_merged, keys.h_merged),
             (rkeys.validity.g_big, keys.validity.g_big),
             (rkeys.validity.h_r, keys.validity.h_r),
             (rkeys.validity.h_blind[None], keys.validity.h_blind[None]),
             (rkeys.validity.g_merged, keys.validity.g_merged)]
    for rv, tv in pairs:
        np.testing.assert_array_equal(to_limbs(tv), np.asarray(rv))
    np.testing.assert_array_equal(
        to_limbs(gk.derive(b"zkdl/ipa-u", 0, 1, "cpu")),
        np.asarray(rgroup.derive_generators(b"zkdl/ipa-u", 1)))


def test_generator_label_must_fit_one_block():
    with pytest.raises(ValueError, match="SHA-256 block"):
        gk.derive(b"x" * (gk.MAX_LABEL_BYTES + 1), 0, 1, "cpu")
    tail = gk.derive(b"t" * gk.MAX_LABEL_BYTES, 5, 3, "cpu")
    np.testing.assert_array_equal(
        tail.numpy(), gk.derive_plain(b"t" * gk.MAX_LABEL_BYTES, 0, 8,
                                      "cpu")[5:].numpy())


def test_wrappers_refuse_other_devices_and_count_only_launches():
    """Only CPU tensors take the plain versions; any other device must
    launch a kernel or raise -- never fall back."""
    kernels.reset_launch_counts()
    x = torch.arange(8, dtype=torch.int64)
    mk.modmul(FQ, x, x)
    fk.fold(x, 5)
    fk.fold_halves(x, 5, 7)
    assert all(v == 0 for v in kernels.launch_counts().values())
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        mk.modmul(FQ, meta, meta)
    with pytest.raises(ValueError):
        fk.fold(meta, 5)
    with pytest.raises(ValueError):
        fk.fold_halves(meta, 5, 7)
    with pytest.raises(ValueError):
        gk.derive(b"zkdl", 0, 4, "meta")


def _msm_inputs(n: int, rows: int, seed: int):
    from repro_torch.core import group
    rng = np.random.default_rng(seed)
    exps = torch.as_tensor(rng.integers(0, FQ.modulus, (rows, n),
                                        dtype=np.uint64).astype(np.int64))
    return group.derive_generators(b"msm-cpu-test", rows * n, "cpu"), exps


def test_msm_wrapper_takes_plain_on_cpu_and_counts_only_launches():
    """CPU tensors take the torch-op Pippenger (no launch counted); any
    other device must launch the kernel or raise."""
    from repro_torch.core import group
    from repro_torch.kernels import msm as km
    pts, exps = _msm_inputs(40, 2, 1)
    kernels.reset_launch_counts()
    got = km.msm([(pts[:40], exps)])
    assert torch.equal(got, group.msm_many_plain(pts[:40], exps))
    assert torch.equal(group.msm_many(pts[:40], exps), got)
    ids = torch.tensor([0] * 30 + [2] * 10)
    assert torch.equal(
        km.msm_ragged(pts[:40], exps[0], ids, 3),
        group.msm_ragged_plain(pts[:40], exps[0], ids, 3))
    assert kernels.launch_counts()["msm"] == 0
    meta = torch.empty(2, 8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        km.msm([(meta[0], meta)])
    with pytest.raises(ValueError):
        km.msm_ragged(meta[0], meta[0], meta[1], 2)
    assert kernels.launch_counts()["msm"] == 0


@pytest.mark.parametrize("case", ["dtype", "rows", "terms", "strided",
                                  "spacing", "segments", "nbits",
                                  "ragged_2d", "ragged_len"])
def test_msm_wrapper_refuses_malformed_inputs(case):
    from repro_torch.kernels import msm as km
    pts, exps = _msm_inputs(16, 3, 2)
    v, exps = pts[:16], exps[:2]
    bad = {
        "dtype": lambda: km.msm([(v, exps.to(torch.int32))]),
        "rows": lambda: km.msm([(pts[:48].view(3, 16), exps)]),
        "terms": lambda: km.msm([(v[:15], exps)]),
        "strided": lambda: km.msm([(v, exps.T.contiguous().T)]),
        "spacing": lambda: km.msm([([v[:8], v[9:]], exps[:, :8])]),
        "segments": lambda: km.msm([(v, exps)] * 4),
        "nbits": lambda: km.msm([(v, exps)], nbits=65),
        "ragged_2d": lambda: km.msm_ragged(v, exps, exps, 2),
        "ragged_len": lambda: km.msm_ragged(v, exps[0],
                                            torch.zeros(15, dtype=torch.int64),
                                            1),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        bad()


@pytest.mark.parametrize("n2", [1, 5, 40])
def test_msm_segments_equal_concatenated_rows_on_cpu(n2):
    """Halves read in place in either order, and a shared two-point tail,
    give each row's concatenated MSM (as the pair IPA's L and R use
    them)."""
    from repro_torch.core import group
    pts, exps = _msm_inputs(2 * n2, 3, 3 + n2)
    g, h, t = pts[:2 * n2], pts[2 * n2:4 * n2], pts[4 * n2:4 * n2 + 2]
    ea, eb = exps[0], exps[1]
    et = torch.stack([exps[2, :2], exps[2, -2:] >> 7])
    segs = [([g[n2:], g[:n2]], [ea[:n2], ea[n2:]]),
            ([h[:n2], h[n2:]], [eb[n2:], eb[:n2]]), (t, et)]
    want = torch.stack([
        group.msm(torch.cat([g[n2:], h[:n2], t]),
                  torch.cat([ea[:n2], eb[n2:], et[0]])),
        group.msm(torch.cat([g[:n2], h[n2:], t]),
                  torch.cat([ea[n2:], eb[:n2], et[1]]))])
    assert torch.equal(group.msm_segments(segs), want)
    assert torch.equal(group.msm_segments(segs[:2]), torch.stack([
        group.msm(torch.cat([g[n2:], h[:n2]]), torch.cat([ea[:n2], eb[n2:]])),
        group.msm(torch.cat([g[:n2], h[n2:]]),
                  torch.cat([ea[n2:], eb[:n2]]))]))


def _pow_words(spec, shape, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, spec.modulus, shape, dtype=np.uint64) % spec.modulus
    e = rng.integers(0, FQ.modulus, shape, dtype=np.uint64) % FQ.modulus
    return (torch.as_tensor(b.astype(np.int64)),
            torch.as_tensor(e.astype(np.int64)))


def test_powmod_wrapper_takes_plain_on_cpu_and_counts_no_launch():
    """CPU tensors take the plain version (no launch counted); any other
    device must launch the kernel or raise."""
    from repro_torch.kernels import powmod as pk
    b, e = _pow_words(FP, 40, 1)
    kernels.reset_launch_counts()
    assert torch.equal(pk.powmod(FP, b, e, 61), pk.powmod_plain(FP, b, e, 61))
    assert torch.equal(pk.powmod(FQ, b % FQ.modulus, 12345),
                       pk.powmod_plain(FQ, b % FQ.modulus, 12345))
    assert kernels.launch_counts()["powmod"] == 0
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        pk.powmod(FP, meta, meta)
    with pytest.raises(ValueError):
        pk.powmod(FP, meta, 5)
    assert kernels.launch_counts()["powmod"] == 0


@pytest.mark.parametrize("case", ["dtype", "exp_dtype", "nbits_0",
                                  "nbits_64", "scalar_neg", "scalar_2_64",
                                  "shapes"])
def test_powmod_wrapper_refuses_malformed_inputs(case):
    from repro_torch.kernels import powmod as pk
    b, e = _pow_words(FP, 4, 2)
    bad = {
        "dtype": lambda: pk.powmod(FP, b.to(torch.int32), e),
        "exp_dtype": lambda: pk.powmod(FP, b, e.to(torch.int32)),
        "nbits_0": lambda: pk.powmod(FP, b, e, nbits=0),
        "nbits_64": lambda: pk.powmod(FP, b, e, nbits=64),
        "scalar_neg": lambda: pk.powmod(FP, b, -1),
        "scalar_2_64": lambda: pk.powmod(FP, b, 1 << 64),
        "shapes": lambda: pk.powmod(FP, b, e[:3]),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        bad()


@pytest.mark.parametrize("nbits", [1, 17, 61])
def test_g_pow_and_pow_const_through_wrapper_match_python_ints(nbits):
    """`group.g_pow` (broadcasting, the low nbits of each exponent) and
    `pow_const` (the exponent whole) on CPU tensors against python-int
    powers."""
    from repro_torch.core import group
    from repro_torch.field import decode, pow_const
    b, e = _pow_words(FP, 24, 3 + nbits)
    e[:4] = torch.tensor([0, 1, FQ.modulus - 1, (1 << 61) - 1])
    p, mask = FP.modulus, (1 << nbits) - 1
    bv = [int(v) for v in decode(FP, b)]
    ev = [int(v) for v in e]
    got = [int(v) for v in decode(FP, group.g_pow(b, e, nbits))]
    assert got == [pow(x, y & mask, p) for x, y in zip(bv, ev)]
    got = decode(FP, group.g_pow(b[5], e[None, :6], nbits)).reshape(-1)
    assert [int(v) for v in got] == [pow(bv[5], y & mask, p) for y in ev[:6]]
    for c in (0, 1, (1 << 61) - 1, FP.modulus - 2, (1 << 64) - 1):
        got = [int(v) for v in decode(FP, pow_const(FP, b, c))]
        assert got == [pow(x, c, p) for x in bv]
