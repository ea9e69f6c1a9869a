"""Port sumcheck, MLE helpers and transcript against the reference: the
same round messages, bound point and finals for the same tables,
products, coefficients and transcript state."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mle as rmle
from repro.core import sumcheck as rsc
from repro.core.transcript import Transcript as RTranscript
from repro.field import FQ as RFQ
from repro.field import modarith as rmod

from repro_torch.core import mle, sumcheck
from repro_torch.core.transcript import Transcript
from repro_torch.interop import from_reference, to_limbs

Q = RFQ.modulus
RNG = np.random.default_rng(17)


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


def _tables(k, n):
    out = []
    for _ in range(k):
        vals = np.array([int(v) % Q for v in RNG.integers(0, Q, n,
                                                         dtype=np.uint64)],
                        dtype=object)
        limbs = rmod.encode_ints(RFQ, vals)
        out.append((limbs, from_reference(limbs, "cpu")))
    return out


def test_transcript_is_a_verbatim_copy():
    a, b = RTranscript(b"lbl"), Transcript(b"lbl")
    for t in (a, b):
        t.absorb_ints(b"x", [1, 2, Q - 1])
        t.absorb_bytes(b"raw", b"\x00\xff")
    assert a.challenge_ints(b"c", Q, 3) == b.challenge_ints(b"c", Q, 3)


CASES = {
    "matmul-pairs": ([(0, 1), (2, 3)], [5, 11]),
    "ragged-deg3": ([(0, 1, 2), (3,), (1, 3)], [3, 1, Q - 2]),
    "anchor-shape": ([(0, 3, 1), (0, 4, 2)], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sumcheck_prove_matches_reference(case):
    products, coefs = CASES[case]
    k = 1 + max(max(p) for p in products)
    tabs = _tables(k, 16)
    rt, tt = RTranscript(b"sc"), Transcript(b"sc")
    r_proof, r_point, r_finals = rsc.sumcheck_prove(
        [jnp.asarray(r) for r, _ in tabs], products, rt, b"lbl", coefs=coefs)
    t_proof, t_point, t_finals = sumcheck.sumcheck_prove(
        [t for _, t in tabs], products, tt, b"lbl", coefs=coefs)
    assert t_proof.messages == r_proof.messages
    assert t_point == r_point and t_finals == r_finals
    assert rt.challenge_int(b"after", Q) == tt.challenge_int(b"after", Q)

    # the port's verifier accepts, and its final matches the products
    vals = [list(rmod.decode(RFQ, r)) for r, _ in tabs]
    claim = 0
    for pi, prod in enumerate(products):
        for b in range(16):
            term = coefs[pi] if coefs else 1
            for kk in prod:
                term = term * vals[kk][b] % Q
            claim = (claim + term) % Q
    degree = max(len(p) for p in products)
    point, expected = sumcheck.sumcheck_verify(
        claim, t_proof, degree, 4, Transcript(b"sc"), b"lbl")
    assert point == t_point
    assert expected == sumcheck.combine_final(products, t_finals, coefs)


def test_sumcheck_verify_rejects_tampered_round():
    tabs = _tables(2, 8)
    proof, _, _ = sumcheck.sumcheck_prove([t for _, t in tabs], [(0, 1)],
                                          Transcript(b"v"), b"l")
    proof.messages[1][0] = (proof.messages[1][0] + 1) % Q
    with pytest.raises(ValueError, match="round consistency"):
        sumcheck.sumcheck_verify(0, proof, 2, 3, Transcript(b"v"), b"l")


def test_mle_helpers_match_reference():
    (ra, ta), (rb, tb), (rc, tc) = _tables(3, 32)
    pt = [int(v) % Q for v in RNG.integers(0, Q, 5, dtype=np.uint64)]
    np.testing.assert_array_equal(to_limbs(mle.expand_point(pt, "cpu")),
                                  np.asarray(rmle.expand_point(pt)))
    folded = ta
    for r in pt:
        folded = mle.fold(folded, mle.enc(r))
    np.testing.assert_array_equal(
        to_limbs(folded),
        np.asarray(rmle.eval_mle(jnp.asarray(ra), pt))[None])
    np.testing.assert_array_equal(
        to_limbs(mle.fdot(ta, tb)),
        np.asarray(rmle.fdot(jnp.asarray(ra), jnp.asarray(rb))))
    np.testing.assert_array_equal(to_limbs(mle.fsum(tc)),
                                  np.asarray(rmle.fsum(jnp.asarray(rc))))
    coefs = [3, Q - 1, 12345]
    np.testing.assert_array_equal(
        to_limbs(mle.weighted_sum(torch.stack([ta, tb, tc]),
                                  mle.enc_vec(coefs, "cpu"))),
        np.asarray(rmle.weighted_sum(jnp.stack([jnp.asarray(ra),
                                                jnp.asarray(rb),
                                                jnp.asarray(rc)]),
                                     rmle.enc_vec(coefs))))
    np.testing.assert_array_equal(
        to_limbs(mle.fdot_many(ta, torch.stack([tb, tc]))),
        np.asarray(rmle.fdot_many(jnp.asarray(ra),
                                  jnp.stack([jnp.asarray(rb),
                                             jnp.asarray(rc)]))))
    assert mle.hexpand_point(pt) == rmle.hexpand_point(pt)
    assert mle.lagrange_eval([1, 5, 9, 2], 77) == rmle.lagrange_eval(
        [1, 5, 9, 2], 77)
