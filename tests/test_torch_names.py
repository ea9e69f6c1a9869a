"""The public names the port's field and core modules share with the
reference: `field` (neg, is_zero, eq, decode_centered, rand_elements,
the limb helpers), `mle.eval_mle`, `group.group_gen`,
`quantfc.dequantize`, `scbd.mle_host_expand`, `ipa.pair_prove` /
`pair_verify` and `zkrelu.prove_validity` / `verify_validity`.

Each runs the reference's own assertions (`tests/test_field.py:44`,
`tests/test_core_primitives.py:29-112`, `tests/test_ipa.py:85-89`,
`tests/test_zkrelu.py:65-157`) on the port's functions, and compares
values with the reference on the same inputs: exactly, since both
packages hold the same residues.  The two IPAs' proofs are compared
with proofs recorded once from the reference on these inputs (its pair
IPA spends 20 s in XLA compiles on a CPU; its validity IPA 70 s with
`repro.core.zkrelu.batch_inv` bound to host inverses, as in
tests/test_torch_zkrelu.py); equal proofs verify on both sides."""
import numpy as np
import pytest
import torch

import repro.field as rfield
from repro.core import group as rgroup
from repro.core import mle as rmle
from repro.core import quantfc as rquant
from repro.core import scbd as rscbd
import repro_torch.field as tfield
from repro_torch.core import group, ipa, mle, quantfc, scbd, zkrelu
from repro_torch.core.mle import eval_mle, expand_point, fdot, fsum
from repro_torch.core.transcript import Transcript
from repro_torch.field import FP, FQ, decode, encode_ints

Q, P = FQ.modulus, FP.modulus
SPECS = [FQ, FP]
DS, QB, RB = 8, 8, 4

# recorded from the reference on the inputs below (see the docstring)
REF_PAIR_N4 = {
    "ls": [2177504092721753752, 276449782732204878],
    "rs": [4564285949658629174, 1176798227103022856],
    "sigma": [4350072885915115714, 4247601506711980384, 484071722590798519,
              1881093012761277331, 1379629825101936901]}
REF_VALIDITY_SEED42 = {
    "coms": [3321668103897975935, 555965426435947559, 2789400395302629123,
             1254621978059809875],
    "ls": [2306671581511745815, 1746866287729908800, 4003374391151768675,
           4118535930058955682, 1754789279930431751, 1709501324969216675,
           2046351410251543085, 2544941545633683185],
    "rs": [4101627363386275095, 43585147357973719, 2487749357538791666,
           3249122387236444170, 2659917825134582638, 2486056974847485526,
           1924407162189139418, 930587536014344940],
    "sigma": [3649441468035683311, 919579863347573057, 2139500555648496446,
              870963889621916627, 1813593952376246272]}


@pytest.fixture(autouse=True, scope="module")
def _reference_without_disk_executables():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKDL_EXEC_MODE", "off")
        yield


def enc(spec, xs):
    return encode_ints(spec, np.array(xs, dtype=object))


def dec(spec, a):
    return decode(spec, a)


def table_from_ints(vals):
    return enc(FQ, [v % Q for v in vals])


# ---------------------------------------------------------------------------
# field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_neg_is_zero_eq_match_python_ints(spec):
    """tests/test_field.py:44 (neg), with is_zero / eq on the same words."""
    rng = np.random.default_rng(0)
    m = spec.modulus
    xs = [int(rng.integers(0, 2**61)) % m for _ in range(64)] + [0, m - 1]
    a = enc(spec, xs)
    assert [int(v) for v in dec(spec, tfield.neg(spec, a))] == \
        [(-x) % m for x in xs]
    assert tfield.is_zero(a).tolist() == [x == 0 for x in xs]
    assert tfield.eq(a, tfield.neg(spec, tfield.neg(spec, a))).all()
    ones = enc(spec, [1] * len(xs))
    assert not tfield.eq(a, tfield.add(spec, a, ones)).any()


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_field_names_equal_reference(spec):
    rspec = {"Fq": rfield.FQ, "Fp": rfield.FP}[spec.name]
    m = spec.modulus
    xs = [0, 1, 2, m - 1, m // 2, m // 2 + 1, 123456789]
    assert decode(spec, tfield.neg(spec, enc(spec, xs))).tolist() == \
        rfield.decode(rspec, rfield.neg(
            rspec, rfield.encode_ints(rspec, np.array(xs, dtype=object)))
        ).tolist()
    got = tfield.decode_centered(spec, enc(spec, xs))
    ref = rfield.decode_centered(rspec, rfield.encode_ints(
        rspec, np.array(xs, dtype=object)))
    assert got.tolist() == ref.tolist()
    assert got.tolist()[3:6] == [-1, m // 2, m // 2 + 1 - m]
    got = tfield.rand_elements(spec, np.random.default_rng(4), (3, 5))
    ref = rfield.rand_elements(rspec, np.random.default_rng(4), (3, 5))
    np.testing.assert_array_equal(got.numpy(), tfield.limbs_to_words(ref))
    for x in (0, 1, 2**63 - 1, 2**64 - 1, m - 1):
        np.testing.assert_array_equal(tfield.int_to_limbs(x),
                                      rfield.int_to_limbs(x))
    vals = np.array([0, 5, 2**62, 2**64 - 1, -3], dtype=object)
    np.testing.assert_array_equal(tfield.ints_to_limbs(vals),
                                  rfield.ints_to_limbs(vals))
    limbs = rfield.ints_to_limbs(np.array([[7, 2**40], [m - 1, 0]],
                                          dtype=object))
    assert tfield.limbs_to_ints(limbs).tolist() == \
        rfield.limbs_to_ints(limbs).tolist()


# ---------------------------------------------------------------------------
# mle, group, quantfc, scbd
# ---------------------------------------------------------------------------

def test_eval_mle_on_hypercube():
    rng = np.random.default_rng(0)
    vals = [int(x) for x in rng.integers(0, 1000, size=8)]
    t = table_from_ints(vals)
    for i in range(8):
        pt = [(i >> j) & 1 for j in range(3)]
        assert int(dec(FQ, eval_mle(t, pt))[()]) == vals[i]


def test_expand_point_matches_eval_and_reference():
    rng = np.random.default_rng(1)
    vals = [int(x) for x in rng.integers(0, Q, size=16, dtype=np.int64)]
    t = table_from_ints(vals)
    pt = [int(rng.integers(0, Q, dtype=np.int64)) for _ in range(4)]
    direct = int(dec(FQ, eval_mle(t, pt))[()])
    assert direct == int(dec(FQ, fdot(t, expand_point(pt, "cpu")))[()])
    assert int(dec(FQ, fsum(expand_point(pt, "cpu")))[()]) == 1
    ref = rmle.eval_mle(rfield.encode_ints(
        rfield.FQ, np.array(vals, dtype=object)), pt)
    assert direct == int(rfield.decode(rfield.FQ, np.asarray(ref))[()])


def test_group_gen_matches_reference():
    g = group.group_gen("cpu")
    assert int(g) == int(tfield.limbs_to_words(np.asarray(rgroup.group_gen())))
    assert group.decode_group(group.g_pow_int(g, 5)) == pow(4, 5, P)
    assert group.decode_group(group.g_pow_int(g, 0)) == 1
    assert group.decode_group(group.g_pow_int(g, Q)) == 1   # order q


def test_dequantize_and_mle_host_expand_match_reference():
    qc, rqc = quantfc.QuantConfig(16, 4), rquant.QuantConfig(16, 4)
    v = np.array([[-32768, -1, 0, 1, 32767]], dtype=np.int64)
    got = quantfc.dequantize(v, qc)
    np.testing.assert_array_equal(got, rquant.dequantize(v, rqc))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(
        quantfc.quantize(got, qc), v)
    pt = [3, Q - 2, 12345]
    assert scbd.mle_host_expand(pt) == rscbd.mle_host_expand(pt)


# ---------------------------------------------------------------------------
# ipa.pair_prove / pair_verify
# ---------------------------------------------------------------------------

def _pair_case(n):
    rng = np.random.default_rng(100 + n)
    g_gens = group.derive_generators(b"pair-G", n, "cpu")
    h_gens = group.derive_generators(b"pair-H", n, "cpu")
    h_blind = group.derive_generators(b"pair-h", 1, "cpu")[0]
    a_int = [int(rng.integers(0, Q, dtype=np.uint64)) % Q for _ in range(n)]
    b_int = [int(rng.integers(0, Q, dtype=np.uint64)) % Q for _ in range(n)]
    a, b = table_from_ints(a_int), table_from_ints(b_int)
    blind = int(rng.integers(0, Q, dtype=np.uint64)) % Q
    claim = sum(x * y for x, y in zip(a_int, b_int)) % Q
    com = group.g_mul(
        group.g_mul(group.msm_field(g_gens, a), group.msm_field(h_gens, b)),
        group.g_pow_int(h_blind, blind))
    return rng, g_gens, h_gens, h_blind, a, b, blind, claim, com


@pytest.mark.parametrize("n", [4, 32])
def test_pair_roundtrip(n):
    """tests/test_ipa.py:70-89 on the port; at n = 4 the proof equals the
    reference's (so each side's verifier accepts the other's)."""
    rng, g_gens, h_gens, h_blind, a, b, blind, claim, com = _pair_case(n)
    proof = ipa.pair_prove(g_gens, h_gens, h_blind, a, b, blind, claim,
                           Transcript(b"pair"), rng)
    assert ipa.pair_verify(g_gens, h_gens, h_blind, com, claim, proof,
                           Transcript(b"pair"), n)
    assert not ipa.pair_verify(g_gens, h_gens, h_blind, com, (claim + 3) % Q,
                               proof, Transcript(b"pair"), n)
    if n == 4:
        assert [proof.ls, proof.rs, proof.sigma] == [
            REF_PAIR_N4["ls"], REF_PAIR_N4["rs"], REF_PAIR_N4["sigma"]]
        ref = ipa.IpaProof(**REF_PAIR_N4)
        assert ipa.pair_verify(g_gens, h_gens, h_blind, com, claim, ref,
                               Transcript(b"pair"), n)


# ---------------------------------------------------------------------------
# zkrelu.prove_validity / verify_validity (tests/test_zkrelu.py:65-157)
# ---------------------------------------------------------------------------

def make_aux(rng, ds=DS):
    zpp = rng.integers(0, 1 << (QB - 1), size=ds).astype(np.int64)
    gap = rng.integers(-(1 << (QB - 1)), 1 << (QB - 1), size=ds).astype(
        np.int64)
    bq = rng.integers(0, 2, size=ds).astype(np.int64)
    rz = rng.integers(0, 1 << RB, size=ds).astype(np.int64)
    rga = rng.integers(0, 1 << RB, size=ds).astype(np.int64)
    return zpp, gap, bq, rz, rga


def honest_claims(zpp, gap, bq, rz, rga, u_relu):
    u_star, upp = u_relu[:-1], u_relu[-1]
    e = mle.hexpand_point(u_star)
    ds = zpp.shape[0]

    def ev(t):
        return sum(int(t[i]) % Q * e[i] for i in range(ds)) % Q
    v = ((1 - upp) * ev(zpp) + upp * ev(gap)) % Q
    vr = ((1 - upp) * ev(rz) + upp * ev(rga)) % Q
    return v, ev(bq), vr


def coms_list(coms):
    return [coms.com_b_ip, coms.com_bq1, coms.com_bq1p, coms.com_br_ip]


@pytest.fixture(scope="module")
def keys():
    return zkrelu.make_validity_keys(DS, QB, RB, "cpu")


def _setup(keys, seed, tamper=None):
    rng = np.random.default_rng(seed)
    aux = make_aux(rng)
    bits = zkrelu.build_aux_bits(*[torch.as_tensor(a) for a in aux], QB, RB)
    if tamper == "bitflip":
        bits.b_mat[3, 2] ^= 1
    if tamper == "value":
        # commitments honest, but the prover's raw witness disagrees
        bits.zpp[3] ^= 4
    coms, blinds = zkrelu.commit_validity(keys, bits, rng)
    return rng, aux, bits, coms, blinds


def run_protocol(keys, tamper=None):
    rng, aux, bits, coms, blinds = _setup(keys, 42, tamper)
    n_vars = DS.bit_length() - 1
    tp = Transcript(b"zkrelu-test")
    tp.absorb_ints(b"coms", coms_list(coms))
    u_relu = tp.challenge_ints(b"urelu", Q, n_vars + 1)
    v, vq1, vr = honest_claims(*aux, u_relu)
    tp.absorb_ints(b"claims", [v, vq1, vr])
    proof = zkrelu.prove_validity(keys, bits, blinds, u_relu, v, vq1, vr,
                                  tp, rng)
    tv = Transcript(b"zkrelu-test")
    tv.absorb_ints(b"coms", coms_list(coms))
    assert tv.challenge_ints(b"urelu", Q, n_vars + 1) == u_relu
    tv.absorb_ints(b"claims", [v, vq1, vr])
    return coms, proof, zkrelu.verify_validity(keys, coms, v, vq1, vr,
                                               u_relu, proof, tv)


def test_validity_accepts_honest_with_the_reference_proof(keys):
    coms, proof, ok = run_protocol(keys)
    assert ok
    ref = REF_VALIDITY_SEED42
    assert coms_list(coms) == ref["coms"]
    assert [proof.ls, proof.rs, proof.sigma] == \
        [ref["ls"], ref["rs"], ref["sigma"]]


@pytest.mark.parametrize("tamper", ["bitflip", "value"])
def test_validity_rejects_tampered_witness(keys, tamper):
    assert not run_protocol(keys, tamper)[2]


def test_validity_rejects_wrong_claim(keys):
    rng, aux, bits, coms, blinds = _setup(keys, 1)
    n_vars = DS.bit_length() - 1
    tp = Transcript(b"t2")
    u_relu = tp.challenge_ints(b"urelu", Q, n_vars + 1)
    v, vq1, vr = honest_claims(*aux, u_relu)
    v_bad = (v + 1) % Q
    tp.absorb_ints(b"claims", [v_bad, vq1, vr])
    proof = zkrelu.prove_validity(keys, bits, blinds, u_relu, v_bad, vq1, vr,
                                  tp, rng)
    tv = Transcript(b"t2")
    u2 = tv.challenge_ints(b"urelu", Q, n_vars + 1)
    tv.absorb_ints(b"claims", [v_bad, vq1, vr])
    assert not zkrelu.verify_validity(keys, coms, v_bad, vq1, vr, u2, proof,
                                      tv)


def test_cross_statement_swap_rejects(keys):
    """A prover that swaps the main / remainder slices inside the merged
    IPA (right claims, wrong basis positions) is rejected."""
    rng, aux, bits, coms, blinds = _setup(keys, 7)
    n_vars = DS.bit_length() - 1
    tp = Transcript(b"swap")
    tp.absorb_ints(b"coms", coms_list(coms))
    u_relu = tp.challenge_ints(b"urelu", Q, n_vars + 1)
    v, vq1, vr = honest_claims(*aux, u_relu)
    tp.absorb_ints(b"claims", [v, vq1, vr])
    st = zkrelu.prove_statements(keys, bits, blinds, u_relu, v, vq1, vr, tp)
    lam = tp.challenge_int(b"zkrelu/lam", Q)
    lam_m = mle.enc(lam)
    pad = keys.merged_len - keys.n_main - keys.n_rem
    zeros = torch.zeros(pad, dtype=torch.int64)
    rep = keys.n_main // keys.n_rem
    a_sw = torch.cat([st.a_rem.repeat(rep), tfield.mont_mul(
        FQ, st.a_main[:keys.n_rem], lam_m), zeros])
    b_sw = torch.cat([st.b_rem.repeat(rep), tfield.mont_mul(
        FQ, st.b_main[:keys.n_rem], lam_m), zeros])
    w = torch.cat([st.w_main, st.w_rem, torch.full_like(zeros, mle.enc(1))])
    claim = (st.claim_main + lam * lam % Q * st.claim_rem) % Q
    blind = (st.blind_main + lam * st.blind_rem) % Q
    stmt = (keys.g_merged, None, keys.h_blind, a_sw, b_sw, blind, claim,
            (keys.g_merged_table, keys.h_merged, keys.h_merged_table, w))
    (proof,) = ipa.pair_prove_many([stmt], tp, rng)
    tv = Transcript(b"swap")
    tv.absorb_ints(b"coms", coms_list(coms))
    u2 = tv.challenge_ints(b"urelu", Q, n_vars + 1)
    tv.absorb_ints(b"claims", [v, vq1, vr])
    assert not zkrelu.verify_validity(keys, coms, v, vq1, vr, u2, proof, tv)
