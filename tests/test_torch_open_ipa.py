"""The port's open IPA (`repro_torch.core.ipa.open_prove` /
`open_verify`) and its generator fold kernel (`pow_mul_halves`) against
the reference.

`pow_mul_plain` (what `pow_mul_halves` runs on CPU tensors) is held
against the reference's Pallas `pow_mul_halves` in interpret mode,
tolerance 0.  The expected open proofs were recorded once from the
reference: `repro.core.ipa.open_prove` on the statements `_statement`
builds here (same key label, vectors, blind, transcript label and rng
seed), run with ``ZKDL_EXEC_MODE=off JAX_PLATFORMS=cpu`` and the default
fold backend; proving there costs about 10 s of XLA compiles per size
on a CPU.  The reference's `open_verify` accepted those proofs and rejected
a wrong claim; here it runs again on the port's proof."""
import numpy as np
import pytest
import torch

from repro.core import ipa as ripa
from repro.core import pedersen as rped
from repro.core.transcript import Transcript as RTranscript
from repro.field import FQ as RFQ, encode_ints as r_encode_ints
from repro.kernels.sumcheck_fold import pow_mul_halves as r_pow_mul

from repro_torch.core import ipa, pedersen
from repro_torch.core.transcript import Transcript
from repro_torch.field import FP, FQ, encode_ints
from repro_torch.interop import from_reference, to_limbs
from repro_torch.kernels.sumcheck_fold import pow_mul_halves, pow_mul_plain

Q, P = FQ.modulus, FP.modulus

# recorded from repro.core.ipa.open_prove (see the module docstring)
REFERENCE_OPEN = {
    4: {"ls": [4382211053812166292, 4042216068204291868],
        "rs": [2188828853597537521, 3416145315375464336],
        "sigma": [2735107827902440284, 101124311392029710,
                  1331422601215684253]},
    16: {"ls": [204629274730037810, 1955574821058280116,
                3010367581791825876, 163671404053625895],
         "rs": [987306250050018967, 287453056513074933, 384381027685017690,
                147014617316420514],
         "sigma": [959932358704530943, 1652497244211831901,
                   392153646318902368]},
}
BLIND = 4321


@pytest.fixture(autouse=True, scope="module")
def _reference_without_disk_executables():
    """Run the reference's wrapped programs through plain `jax.jit` (its
    on-disk executable cache ignores the device count)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKDL_EXEC_MODE", "off")
        yield


@pytest.mark.parametrize("e_lo,e_hi", [
    (1, 0x0BADC0FFEE12345),                  # the pair fold's merge
    ((1 << 61) - 1, 1 << 60),                # top bits set
    (0, 987654321),                          # x^0 = 1, even for x = 0
])
def test_pow_mul_plain_matches_reference_kernel(e_lo, e_hi):
    rng = np.random.default_rng(e_hi % 1000)
    vals = [int(v) % P for v in rng.integers(0, P, 256, dtype=np.uint64)]
    vals[:3] = [0, 1, P - 1]
    vals[128:131] = [P - 1, 0, 1]
    gens = encode_ints(FP, vals)
    got = pow_mul_plain(gens, e_lo, e_hi)
    assert torch.equal(pow_mul_halves(gens, e_lo, e_hi), got)
    ref = r_pow_mul(to_limbs(gens), np.array(_limbs(e_lo)),
                    np.array(_limbs(e_hi)), interpret=True)
    assert torch.equal(got, from_reference(np.asarray(ref), "cpu"))


def _limbs(e: int):
    return [(e >> (16 * i)) & 0xFFFF for i in range(4)]


def test_pow_mul_rejects_exponents_outside_61_bits():
    with pytest.raises(ValueError):
        pow_mul_halves(encode_ints(FP, [1, 2]), 1 << 61, 1)


def _statement(n: int):
    rng = np.random.default_rng(100 + n)
    a = [int(v) % Q for v in rng.integers(0, Q, n, dtype=np.uint64)]
    b = [int(v) % Q for v in rng.integers(0, Q, n, dtype=np.uint64)]
    claim = sum(x * y for x, y in zip(a, b)) % Q
    return a, b, claim


@pytest.fixture(scope="module")
def proofs():
    out = {}
    for n in REFERENCE_OPEN:
        a, b, claim = _statement(n)
        key = pedersen.make_key(b"test/open", n, "cpu")
        proof = ipa.open_prove(key, encode_ints(FQ, a), encode_ints(FQ, b),
                               BLIND, claim, Transcript(b"open-test"),
                               np.random.default_rng(9))
        com = pedersen.commit(key, encode_ints(FQ, a), BLIND)
        out[n] = (key, com, b, claim, proof)
    return out


@pytest.mark.parametrize("n", [4, 16])
def test_open_proof_matches_reference(proofs, n):
    proof = proofs[n][-1]
    assert (proof.ls, proof.rs, proof.sigma) == (
        REFERENCE_OPEN[n]["ls"], REFERENCE_OPEN[n]["rs"],
        REFERENCE_OPEN[n]["sigma"])


@pytest.mark.parametrize("n", [4, 16])
def test_port_verifier_accepts_reference_proof_and_rejects_wrong_claim(
        proofs, n):
    key, com, b, claim, _ = proofs[n]
    ref_proof = ipa.IpaProof(**REFERENCE_OPEN[n])
    bm = encode_ints(FQ, b)
    assert ipa.open_verify(key, com, bm, claim, ref_proof,
                           Transcript(b"open-test"))
    assert not ipa.open_verify(key, com, bm, (claim + 1) % Q, ref_proof,
                               Transcript(b"open-test"))
    short = ipa.IpaProof(ref_proof.ls[:-1], ref_proof.rs[:-1],
                         ref_proof.sigma)
    assert not ipa.open_verify(key, com, bm, claim, short,
                               Transcript(b"open-test"))


def test_reference_verifier_accepts_port_proof(proofs):
    """At n = 4 only: the reference verifier compiles anew for each size,
    and the n = 16 proof equals the recorded reference proof above."""
    n = 4
    _, com, b, claim, proof = proofs[n]
    rkey = rped.make_key(b"test/open", n)
    rproof = ripa.IpaProof(list(proof.ls), list(proof.rs), list(proof.sigma))
    rcom = to_limbs(com)
    rb = r_encode_ints(RFQ, b)
    assert ripa.open_verify(rkey, rcom, rb, claim, rproof,
                            RTranscript(b"open-test"))
    assert not ripa.open_verify(rkey, rcom, rb, (claim + 1) % Q, rproof,
                                RTranscript(b"open-test"))
