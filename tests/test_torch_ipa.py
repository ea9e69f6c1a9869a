"""Port pair IPA (`repro_torch.core.ipa`) against the reference.

The expected proofs are digests of the reference's
`repro.core.ipa.pair_prove_many` on the same seeded statements (plain
and first-round-accelerated), recorded once: re-proving with JAX here
would spend most of this file's time budget compiling.  The port's own
verifier must accept the port's proofs and reject a tampered one."""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core import group, ipa
from repro_torch.core.transcript import Transcript
from repro_torch.field import FQ, encode_ints

Q = FQ.modulus

# sha256 over the decimal L, R and sigma values of the reference proof
REFERENCE_PROOF_SHA256 = {
    False: "eb634c27eb08b889ebda4b0314f88640bc09acda027557942fd67a020d31f9bc",
    True: "42cc3494dbe581b114af7c31570d091718a361744730b80a88fee3d7c34b64cc",
}


def _digest(proof) -> str:
    vals = proof.ls + proof.rs + proof.sigma
    return hashlib.sha256(",".join(str(int(v)) for v in vals).encode()
                          ).hexdigest()


def _statement(accel: bool, n: int = 16):
    rng = np.random.default_rng(41)
    a = [int(v) % Q for v in rng.integers(0, Q, n, dtype=np.uint64)]
    b = [int(v) % Q for v in rng.integers(0, Q, n, dtype=np.uint64)]
    claim = sum(x * y for x, y in zip(a, b)) % Q
    gg = group.derive_generators(b"test/ipa-g", n, "cpu")
    hh = group.derive_generators(b"test/ipa-h", n, "cpu")
    hb = group.derive_generators(b"test/ipa-hb", 1, "cpu")[0]
    am, bm = encode_ints(FQ, a), encode_ints(FQ, b)
    if not accel:
        return (gg, hh, hb, am, bm, 777, claim), hh, claim
    w = [int(v) % Q or 1 for v in rng.integers(0, Q, n, dtype=np.uint64)]
    wm = encode_ints(FQ, w)
    stmt = (gg, None, hb, am, bm, 777, claim,
            (group.pow_table(gg), hh, group.pow_table(hh), wm))
    # the H basis the verifier sees: h^{w}
    return stmt, group.g_pow(hh, torch.as_tensor(w)), claim


def _commitment(stmt, h_true):
    gg, _, hb, am, bm, blind = stmt[:6]
    from repro_torch.field import from_mont
    exps = torch.cat([from_mont(FQ, am), from_mont(FQ, bm),
                      torch.tensor([blind])])
    return group.msm(torch.cat([gg, h_true, hb[None]]), exps)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "accel"])
def proved(request):
    stmt, h_true, claim = _statement(request.param)
    (proof,) = ipa.pair_prove_many([stmt], Transcript(b"ipa-test"),
                                   np.random.default_rng(5))
    return request.param, stmt, h_true, claim, proof


def test_pair_proof_matches_reference(proved):
    accel, _, _, _, proof = proved
    assert len(proof.ls) == len(proof.rs) == 4 and len(proof.sigma) == 5
    assert _digest(proof) == REFERENCE_PROOF_SHA256[accel]


def test_pair_proof_verifies_and_tamper_rejects(proved):
    _, stmt, h_true, claim, proof = proved
    com = _commitment(stmt, h_true)
    gg, hb = stmt[0], stmt[2]
    vstmt = [(gg, h_true, hb, com, claim, 16)]
    assert ipa.pair_verify_many(vstmt, [proof], Transcript(b"ipa-test"))
    bad = ipa.IpaProof(list(proof.ls), list(proof.rs), list(proof.sigma))
    bad.sigma[2] = (bad.sigma[2] + 1) % Q
    assert not ipa.pair_verify_many(vstmt, [bad], Transcript(b"ipa-test"))
    wrong_claim = [(gg, h_true, hb, com, (claim + 1) % Q, 16)]
    assert not ipa.pair_verify_many(wrong_claim, [proof],
                                    Transcript(b"ipa-test"))


def test_lockstep_statements_verify_together():
    s1, h1, c1 = _statement(False, n=8)
    s2, h2, c2 = _statement(True, n=4)
    p1, p2 = ipa.pair_prove_many([s1, s2], Transcript(b"two"),
                                 np.random.default_rng(1))
    stmts = [(s1[0], h1, s1[2], _commitment(s1, h1), c1, 8),
             (s2[0], h2, s2[2], _commitment(s2, h2), c2, 4)]
    assert ipa.pair_verify_many(stmts, [p1, p2], Transcript(b"two"))
