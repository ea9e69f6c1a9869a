"""A whole run at a size the CPU proves in seconds with an answer
altered where it is produced: a proof byte flipped after encoding (the
verifier rejects it), and a verifier that accepts whatever it is given
(the tampered proof gets through).  Both make `correct` false."""
import pytest

import zkbench_tiny


def _flip(encode):
    def flipped(proof):
        raw = bytearray(encode(proof))
        raw[len(raw) // 2] ^= 0x04
        return bytes(raw)
    return flipped


@pytest.mark.parametrize("fault", ["proof_byte", "verifier_accepts"])
def test_answer_faults(fault, monkeypatch):
    from repro_torch.core.pipeline import proofio, verifier

    if fault == "proof_byte":
        monkeypatch.setattr(proofio, "encode_proof",
                            _flip(proofio.encode_proof))
    else:
        monkeypatch.setattr(verifier, "verify_bytes",
                            lambda *args, **kwargs: True)
    result = zkbench_tiny.run(seed=2**31 + 12)
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert not result["correct"]
    if fault == "proof_byte":
        assert checks["honest_rejected"] == 1 and result["failed"] == 1
    else:
        assert checks["tampered_accepted"] == 1
        assert checks["honest_rejected"] == 0
