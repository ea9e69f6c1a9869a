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
