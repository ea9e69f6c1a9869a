"""Port field arithmetic (`repro_torch.field`) against the reference
(`repro.field`): the same Montgomery residues, element by element, for
both fields, on random values and on 0, 1 and m-1 -- plus the limb/word
repack and the import isolation of the port package."""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.field import FP as RFP, FQ as RFQ
from repro.field import modarith as rmod
from repro_torch.field import FP, FQ, modarith as tmod
from repro_torch.interop import from_reference, to_limbs

SPECS = [(RFQ, FQ), (RFP, FP)]
IDS = ["Fq", "Fp"]


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


def _values(spec, n, seed):
    rng = np.random.default_rng(seed)
    m = spec.modulus
    rand = [int(v) % m for v in rng.integers(0, m, n, dtype=np.uint64)]
    return np.array([0, 1, m - 1, 2, m - 2] + rand, dtype=object)


def _pair(rspec, n=64, seed=0):
    """The same elements as reference limbs and as port words."""
    a = rmod.encode_ints(rspec, _values(rspec, n, seed))
    b = rmod.encode_ints(rspec, _values(rspec, n, seed + 1)[::-1].copy())
    return (a, b), (from_reference(a, "cpu"), from_reference(b, "cpu"))


def test_constants_match_reference():
    for rspec, spec in SPECS:
        assert (spec.modulus, spec.nprime16, spec.r1, spec.r2) == (
            rspec.modulus, rspec.nprime16, rspec.r1, rspec.r2)
        assert (spec.modulus * spec.nprime64 + 1) % (1 << 64) == 0
        assert spec.modulus < (1 << 62)


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_binary_ops_match_reference(specs, op):
    rspec, spec = specs
    (ra, rb), (ta, tb) = _pair(rspec)
    want = np.asarray(getattr(rmod, op)(rspec, jnp.asarray(ra),
                                        jnp.asarray(rb)))
    got = getattr(tmod, op)(spec, ta, tb)
    np.testing.assert_array_equal(to_limbs(got), want)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_mont_mul_scalar_and_broadcast(specs):
    rspec, spec = specs
    (ra, _), (ta, _) = _pair(rspec)
    s = rmod.encode_int(rspec, 987654321)
    want = np.asarray(rmod.mont_mul(rspec, jnp.asarray(ra),
                                    jnp.asarray(s)[None]))
    s_word = int(from_reference(s, "cpu"))
    np.testing.assert_array_equal(to_limbs(tmod.mont_mul(spec, ta, s_word)),
                                  want)
    col = tmod.mont_mul(spec, ta[:, None], ta[None, :8])
    assert col.shape == (ta.shape[0], 8)
    np.testing.assert_array_equal(
        col[:, 3].numpy(), tmod.mont_mul(spec, ta, ta[3]).numpy())


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("conv", ["to_mont", "from_mont"])
def test_unary_ops_match_reference(specs, conv):
    rspec, spec = specs
    (ra, _), (ta, _) = _pair(rspec)
    want = np.asarray(getattr(rmod, conv)(rspec, jnp.asarray(ra)))
    np.testing.assert_array_equal(to_limbs(getattr(tmod, conv)(spec, ta)),
                                  want)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
@pytest.mark.parametrize("e", [0, 1, 5, 1 << 40, None])
def test_pow_const_matches_python_ints(specs, e):
    """Against python-int ground truth: the reference's jitted pow of a
    61-bit exponent unrolls ~120 multiplies into one XLA program, whose
    compile alone outlasts this suite's per-file budget."""
    rspec, spec = specs
    m = spec.modulus
    e = m - 2 if e is None else e
    (ra, _), (ta, _) = _pair(rspec, n=8)
    got = tmod.decode(spec, tmod.pow_const(spec, ta, e))
    want = [pow(int(v), e, m) for v in rmod.limbs_to_ints(
        rmod.from_mont(rspec, jnp.asarray(ra)))]
    assert list(got) == want


@pytest.mark.parametrize("with_zero", [False, True])
def test_batch_inv_matches_reference_semantics(with_zero):
    """Inverses equal python-int inverses; like the reference's
    Montgomery trick, one zero entry zeroes the whole output."""
    _, (ta, _) = _pair(RFQ, n=16)
    ta = ta[3:].clone()                   # drop 0, 1, m-1
    if with_zero:
        ta[4] = 0
    got = list(tmod.decode(FQ, tmod.batch_inv(FQ, ta)))
    q = FQ.modulus
    vals = list(tmod.decode(FQ, ta))
    want = ([0] * len(vals) if with_zero
            else [pow(int(v), q - 2, q) for v in vals])
    assert got == want


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_encode_decode_match_reference(specs):
    rspec, spec = specs
    xs = np.array([0, 1, -1, -(1 << 62), (1 << 62) + 7, 12345],
                  dtype=object)
    np.testing.assert_array_equal(to_limbs(tmod.encode_ints(spec, xs)),
                                  rmod.encode_ints(rspec, xs))
    i64 = np.array([0, 1, -1, -5, 1 << 40, -(1 << 62)], dtype=np.int64)
    np.testing.assert_array_equal(
        to_limbs(tmod.encode_i64(spec, torch.from_numpy(i64))),
        rmod.encode_i64(rspec, i64))
    (ra, _), (ta, _) = _pair(rspec)
    assert list(tmod.decode(spec, ta)) == list(rmod.decode(rspec, ra))


def test_fsum_matches_host_sum():
    _, (ta, tb) = _pair(RFQ, n=200)
    vals = tmod.decode(FQ, ta)
    total = int(tmod.decode(FQ, tmod.fsum(FQ, ta))[()])
    assert total == sum(vals) % FQ.modulus
    rows = torch.stack([ta, tb])
    got = tmod.decode(FQ, tmod.fsum(FQ, rows, dim=0))
    want = (tmod.decode(FQ, ta) + tmod.decode(FQ, tb)) % FQ.modulus
    assert list(got) == list(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_limb_word_repack_is_exact(seed):
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, (5, 7, 4)).astype(np.uint32)
    limbs[..., 3] &= 0x3FFF                 # canonical words are < 2^62
    words = tmod.limbs_to_words(limbs)
    assert words.dtype == np.int64 and (words >= 0).all()
    np.testing.assert_array_equal(tmod.words_to_limbs(words), limbs)
    np.testing.assert_array_equal(to_limbs(from_reference(limbs, "cpu")),
                                  limbs)


def test_hash_to_int_matches_reference():
    for data in (b"", b"zkdl", bytes(range(70))):
        assert tmod.hash_to_int(data, FP.modulus) == rmod.hash_to_int(
            data, RFP.modulus)


def test_port_imports_neither_jax_nor_repro():
    """repro_torch must import with jax and repro unavailable."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch, repro_torch.interop, repro_torch.kernels\n"
        "import repro_torch.core.pipeline as p\n"
        "import repro_torch.core.zkrelu, repro_torch.core.ipa\n"
        "import repro_torch.configs.registry, repro_torch.data.pipeline\n"
        "import repro_torch.models.config, repro_torch.models.layers\n"
        "import repro_torch.models.attention, repro_torch.models.blockwise\n"
        "import repro_torch.models.ssm, repro_torch.models.moe\n"
        "import repro_torch.models.transformer, repro_torch.tree\n"
        "import repro_torch.train.optim, repro_torch.train.compression\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "from repro_torch.configs.registry import ARCHS, get_config\n"
        "for a in ARCHS:\n"
        "    get_config(a)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch._device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
