"""The port's SC-BD baseline (`repro_torch.core.scbd`) on the CPU.

The golden digest is the reference's (tests/test_scbd.py): the port's
proof of the same tensor on the audit transcript domain must hash to
it.  At other sizes the reference's host verifier must accept the
port's proofs and reject their forgeries, as the port's own does.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import scbd as ref_scbd
from repro.core.sumcheck import SumcheckProof as RefSumcheckProof
from repro_torch.core import scbd
from repro_torch.core.transcript import Transcript

GOLDEN_DIGEST = \
    "4b741340fd0f64f4c567b06911049dac8e71a23d0b02a47751fa430823ece455"


def rand_aux(d, qb, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << (qb - 1)), 1 << (qb - 1), size=d
                        ).astype(np.int64)


def as_reference(proof):
    """The port's proof as the reference's dataclass (same fields)."""
    return ref_scbd.ScbdProof(
        proof.claim, RefSumcheckProof([list(m) for m in
                                       proof.sc_main.messages]),
        list(proof.main_finals),
        RefSumcheckProof([list(m) for m in proof.sc_bin.messages]),
        list(proof.bin_finals))


def test_golden_digest_on_audit_transcript_domain():
    aux = (((np.arange(16, dtype=np.int64) * 37) % 256) - 128).astype(
        np.int64)
    proof = scbd.prove(aux, 8, Transcript(b"zkdl/scbd-audit"), device="cpu")
    assert scbd.verify(proof, 16, 8, Transcript(b"zkdl/scbd-audit"))
    assert proof.digest() == GOLDEN_DIGEST
    assert len(proof.proof_ints()) == 101
    forged = dataclasses.replace(proof,
                                 claim=(proof.claim + 1) % scbd.Q_MOD)
    assert forged.digest() != proof.digest()
    assert not scbd.verify(forged, 16, 8, Transcript(b"zkdl/scbd-audit"))


def _forge(proof, what):
    if what == "claim":
        proof.claim = (proof.claim + 1) % scbd.Q_MOD
    elif what == "round":
        msgs = proof.sc_main.messages
        msgs[1][0] = (msgs[1][0] + 1) % scbd.Q_MOD
    else:                                 # a non-binary witness
        proof.bin_finals[2] = (proof.bin_finals[2] + 1) % scbd.Q_MOD
    return proof


@pytest.mark.parametrize("what", ["claim", "round", "bin_final"])
@pytest.mark.parametrize("d,qb", [(16, 8), (32, 16)])
def test_roundtrip_and_tamper_rejection(d, qb, what):
    aux = rand_aux(d, qb, seed=d + qb)
    proof = scbd.prove(aux, qb, Transcript(b"scbd"), device="cpu")
    assert scbd.verify(proof, d, qb, Transcript(b"scbd"))
    assert ref_scbd.verify(as_reference(proof), d, qb, Transcript(b"scbd"))
    assert proof.size_bytes() == as_reference(proof).size_bytes()
    forged = _forge(proof, what)
    assert not scbd.verify(forged, d, qb, Transcript(b"scbd"))
    assert not ref_scbd.verify(as_reference(forged), d, qb,
                               Transcript(b"scbd"))


def test_tensor_input_and_workload():
    import torch
    aux = rand_aux(16, 8, seed=3)
    a = scbd.prove(aux, 8, Transcript(b"scbd"), device="cpu")
    b = scbd.prove(torch.as_tensor(aux), 8, Transcript(b"scbd"))
    assert a.digest() == b.digest()
    assert scbd.workload_elems(1024, 16) == \
        ref_scbd.workload_elems(1024, 16) == 1024 * 1024 * 16
