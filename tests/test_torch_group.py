"""Port group operations, MSM and Pedersen commitments against the
reference: the same group elements for the same bases and exponents
(the port's sort-based Pippenger and the reference's scan-based one
reduce in different orders; the group is commutative and exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import group as rgroup
from repro.core import pedersen as rped
from repro.field import FQ as RFQ
from repro.field import modarith as rmod

from repro_torch.core import group, pedersen
from repro_torch.field import FP
from repro_torch.interop import from_reference, to_limbs

Q, P = RFQ.modulus, FP.modulus
RNG = np.random.default_rng(23)


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


@pytest.fixture(scope="module")
def bases():
    r = rgroup.derive_generators(b"test/torch-group", 80)
    return r, group.derive_generators(b"test/torch-group", 80, "cpu")


def _exps(n, zeros=()):
    e = [int(v) % Q for v in RNG.integers(0, Q, n, dtype=np.uint64)]
    for i in zeros:
        e[i] = 0
    return e


def test_generators_and_codecs_match_reference(bases):
    r, t = bases
    np.testing.assert_array_equal(to_limbs(t), np.asarray(r))
    assert group.decode_group_many(t[:5]) == rgroup.decode_group_many(r[:5])
    for x in (0, 1, P - 1, 12345678901234):
        np.testing.assert_array_equal(
            to_limbs(group.encode_group(x, "cpu")),
            np.asarray(rgroup.encode_group(x)))


@pytest.mark.parametrize("n,window", [(3, None), (33, None), (80, None),
                                      (80, 2), (64, 5)])
def test_msm_matches_reference(bases, n, window):
    r, t = bases
    e = _exps(n, zeros=(1,))
    want = rgroup.decode_group(rgroup.msm(r[:n], rgroup.exps_from_ints(e)))
    got = group.decode_group(group.msm(t[:n], group.exps_from_ints(e, "cpu"),
                                       window=window))
    assert got == want


def test_msm_many_and_ragged_match_per_row(bases):
    r, t = bases
    rows = [_exps(48) for _ in range(3)]
    want = rgroup.decode_group_many(rgroup.msm_many(
        r[:48], jnp.stack([rgroup.exps_from_ints(e) for e in rows])))
    exps = torch.stack([group.exps_from_ints(e, "cpu") for e in rows])
    assert group.decode_group_many(group.msm_many(t[:48], exps)) == want
    lens = (10, 48, 7)
    flat = torch.cat([exps[i, :k] for i, k in enumerate(lens)])
    pts = torch.cat([t[:k] for k in lens])
    ids = torch.cat([torch.full((k,), i) for i, k in enumerate(lens)])
    got = group.decode_group_many(group.msm_ragged(pts, flat, ids, 3))
    assert got == [group.decode_group(group.msm(t[:k], exps[i, :k]))
                   for i, k in enumerate(lens)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_products_match_python(seed):
    rng = np.random.default_rng(seed)
    n, nkeys = int(rng.integers(1, 200)), 9
    keys = np.sort(rng.integers(0, nkeys, n))
    vals = rng.integers(2, P, n)
    out = torch.full((nkeys + 1,), FP.one, dtype=torch.int64)
    mont = torch.as_tensor([v * (1 << 64) % P for v in vals.tolist()])
    group._segment_products(torch.as_tensor(keys), mont, out, nkeys)
    want = [1] * nkeys
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[k] = want[k] * v % P
    assert group.decode_group_many(out[:nkeys]) == want


def test_pow_tree_and_bits_match_reference(bases):
    r, t = bases
    e = _exps(16, zeros=(0,))
    np.testing.assert_array_equal(
        to_limbs(group.g_pow(t[:16], group.exps_from_ints(e, "cpu"))),
        np.asarray(rgroup.g_pow(r[:16], rgroup.exps_from_ints(e))))
    tab = group.pow_table(t[:8], nbits=61)
    np.testing.assert_array_equal(
        to_limbs(group.g_pow_table(tab, group.exps_from_ints(e[:8], "cpu"))),
        np.asarray(rgroup.g_pow(r[:8], rgroup.exps_from_ints(e[:8]))))
    np.testing.assert_array_equal(to_limbs(group.tree_prod(t[:13])),
                                  np.asarray(rgroup.tree_prod(r[:13])))
    bits = RNG.integers(0, 2, 21).astype(np.uint32)
    np.testing.assert_array_equal(
        to_limbs(group.msm_bits(t[:21], torch.as_tensor(bits))),
        np.asarray(rgroup.msm_bits(r[:21], jnp.asarray(bits))))
    np.testing.assert_array_equal(to_limbs(group.g_inv(t[3])),
                                  np.asarray(rgroup.g_inv(r[3])))


def test_pedersen_commitments_match_reference(bases):
    rk = rped.make_key(b"torch-ped", 40)
    tk = pedersen.CommitKey(
        group.derive_generators(b"zkdl/gens/torch-ped", 40, "cpu"),
        group.derive_generators(b"zkdl/blind/torch-ped", 1, "cpu")[0],
        b"torch-ped")
    v1 = [int(x) for x in RNG.integers(-1000, 1000, 40)]
    v2 = [int(x) for x in RNG.integers(-50, 50, 17)]
    r1, r2 = rmod.encode_ints(RFQ, np.array(v1, dtype=object)), \
        rmod.encode_ints(RFQ, np.array(v2, dtype=object))
    want = rgroup.decode_group_many(rped.commit_many(
        [(rk, jnp.asarray(r1), 99), (rk, jnp.asarray(r2), 12345)]))
    got = group.decode_group_many(pedersen.commit_many(
        [(tk, from_reference(r1, "cpu"), 99),
         (tk, from_reference(r2, "cpu"), 12345)]))
    assert got == want
    assert group.decode_group(pedersen.commit(
        tk, from_reference(r2, "cpu"), 12345)) == want[1]
    assert group.decode_group(pedersen.commit_ints(tk, v1, 99)) == want[0]
    bits = RNG.integers(0, 2, 30)
    assert group.decode_group(pedersen.commit_bits(
        tk, torch.as_tensor(bits), 7)) == rgroup.decode_group(
        rped.commit_bits(rk, jnp.asarray(bits.astype(np.uint32)), 7))
