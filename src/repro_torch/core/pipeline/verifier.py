"""Standalone verifier for aggregated pipeline proofs.

Mirrors the prover's transcript schedule exactly: absorb commitments,
draw the challenge schedule, replay steps (a)/(b)/(c) over the graph's
shape buckets.  Step (c) ends in ONE merged pair-IPA check that covers
every committed-tensor opening AND both zkReLU validity statements
(format v3; see openings.verify).  Soundness checks are expressed as
ValueError raises inside the stage modules; this module converts them
into an accept/reject bit (plus an optional failure trace for
telemetry).
"""
from __future__ import annotations

from repro_torch.core.pipeline import anchor as anchor_mod
from repro_torch.core.pipeline import matmul as matmul_mod
from repro_torch.core.pipeline import openings as openings_mod
from repro_torch.core.pipeline.challenges import ChallengeSchedule, pi_bases
from repro_torch.core.pipeline.config import PipelineKeys
from repro_torch.core.pipeline.session import AggregatedProof
from repro_torch.core.transcript import Transcript


def verify(keys: PipelineKeys, proof: AggregatedProof,
           transcript: Transcript, trace: list | None = None) -> bool:
    """Trusted-verifier side of the aggregated protocol.

    If ``trace`` is a list, the name of the first failing check is
    appended (debugging/telemetry; does not affect soundness).
    """
    cfg = keys.cfg
    t = transcript
    op = proof.openings
    try:
        if proof.n_steps != cfg.n_steps:
            raise ValueError("step-count")
        if len(proof.coms.x) != cfg.n_steps * cfg.batch:
            raise ValueError("x-commitment-count")
        # the slot names AND their order are part of the format contract
        # (transcript absorption order + every coms.<name> lookup below)
        if list(proof.coms.slots) != [s.name for s in
                                      cfg.graph.commit_slots]:
            raise ValueError("commitment-schema")
        t.absorb_ints(b"coms", proof.coms.as_ints())
        ch = ChallengeSchedule.draw(t, cfg)
        t.absorb_ints(b"op1", [op[k] for k in ("a1", "a2", "a3",
                                               "a4", "a5", "a6")])
        e_pi1, e_pi2, e_pi3 = pi_bases(ch, keys.device)

        points = matmul_mod.verify(cfg, proof, op, ch, t)        # step (a)
        u_star = anchor_mod.verify(cfg, proof, ch, points, t)    # step (b)
        openings_mod.verify(cfg, keys, proof, proof.coms, ch,    # step (c)
                            points, u_star, e_pi1, e_pi2, e_pi3, t)
        return True
    # ValueError: failed soundness checks / inconsistent transcript;
    # KeyError/IndexError: structurally malformed proof fields;
    # TypeError/OverflowError/ZeroDivisionError: decoded-but-garbage
    # fields hitting arithmetic (all reachable from attacker bytes, per
    # the fuzz suite).  Verifier-side programming errors
    # (AssertionError etc.) propagate -- an infrastructure bug must not
    # masquerade as a forged proof.
    except (ValueError, KeyError, IndexError, TypeError, OverflowError,
            ZeroDivisionError) as exc:
        if trace is not None:
            arg = exc.args[0] if exc.args else exc
            trace.append(arg if isinstance(arg, str) else f"exception: {exc!r}")
        return False


def verify_session(keys: PipelineKeys, proof: AggregatedProof,
                   label: bytes = b"zkdl",
                   trace: list | None = None) -> bool:
    return verify(keys, proof, Transcript(label), trace=trace)


def verify_bytes(vk, proof_bytes: bytes, label: bytes = b"zkdl",
                 trace: list | None = None) -> bool:
    """The deployment-side verifier: accept/reject from SERIALIZED bytes
    and a `VerifyingKey` alone — no session, no prover state.  Malformed
    byte streams reject (with the decode error in ``trace``) rather than
    raise: a forged proof must never crash the verifier."""
    from repro_torch.core.pipeline.proofio import (ProofDecodeError,
                                                   decode_proof)
    from repro_torch.core.pipeline.session import _as_pipeline_keys

    try:
        proof = decode_proof(proof_bytes)
    except ProofDecodeError as exc:
        if trace is not None:
            trace.append(f"decode: {exc}")
        return False
    return verify(_as_pipeline_keys(vk), proof, Transcript(label),
                  trace=trace)
