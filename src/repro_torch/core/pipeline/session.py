"""`ProofSession`: accumulate T training-step witnesses, emit ONE proof.

This is the FAC4DNN deployment surface: the trainer calls ``add_step``
once per batch update and ``prove`` once per aggregation window; the
committed tensors, the transcript, the bucketed matmul sumchecks, the
anchor sumcheck, the zkReLU validity argument and every IPA opening are
all shared across the window's T steps -- and, through the layer-graph
shape buckets, across heterogeneous layer shapes -- so per-step proof
size and per-step fixed proving cost fall as T grows (see
the reference's benchmarks/agg_steps.py for the amortization curve).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import group, ipa, pedersen, zkrelu
from repro_torch.core.quantfc import StepWitness
from repro_torch.core.sumcheck import SumcheckProof
from repro_torch.core.transcript import Transcript
from repro_torch.core.pipeline import anchor as anchor_mod
from repro_torch.core.pipeline import matmul as matmul_mod
from repro_torch.core.pipeline import openings as openings_mod
from repro_torch.core.pipeline.challenges import ChallengeSchedule
from repro_torch.core.pipeline.config import PipelineKeys
from repro_torch.core.pipeline.profile import PhaseProfile, proof_counts
from repro_torch.core.pipeline.tables import rand_scalar
from repro_torch.core.pipeline.witness import (StackedWitness,
                                               build_field_tables,
                                               stack_witnesses)


@dataclasses.dataclass
class SessionCommitments:
    """Everything the trainer publishes before the interaction, keyed by
    the graph's commitment schema (`LayerGraph.commit_slots`): ``slots``
    maps each declared tensor-slot name ("y", "w", "zpp", ...) to its
    stacked Pedersen commitment, in schema order; the x list holds the
    per-sample data commitments of ALL T steps, t-major (Section 4.4
    folded-data path).  Slot commitments are also readable as attributes
    (``coms.zpp``)."""
    x: List[int]
    slots: Dict[str, int]
    validity: zkrelu.ValidityCommitments

    def __getattr__(self, name: str):
        if name.startswith("_") or name == "slots":
            raise AttributeError(name)
        try:
            return self.slots[name]
        except KeyError:
            raise AttributeError(name) from None

    def as_ints(self) -> List[int]:
        """Transcript absorption order: x rows, then the schema slots in
        declaration order, then the validity commitments."""
        return (self.x + list(self.slots.values())
                + [self.validity.com_b_ip, self.validity.com_bq1,
                   self.validity.com_bq1p, self.validity.com_br_ip])


@dataclasses.dataclass
class AggregatedProof:
    """One transcript covering all T aggregated steps.

    Sumchecks and finals are per shape bucket (one entry per bucket, in
    the graph's bucket order); the ``*_claims`` lists carry the per-
    bucket split of the family claim target and stay empty for single-
    bucket (uniform-width) graphs, whose transcript is bit-identical to
    the seed's."""
    coms: SessionCommitments
    openings: Dict[str, int]               # claim values, by name
    sc_fwd: List[SumcheckProof]
    sc_bwd: List[SumcheckProof]
    sc_gw: List[SumcheckProof]
    sc_anchor: SumcheckProof
    fwd_finals: List[List[int]]
    bwd_finals: List[List[int]]
    gw_finals: List[List[int]]
    fwd_claims: List[int]
    bwd_claims: List[int]
    gw_claims: List[int]
    anchor_finals: List[int]
    #: the ONE merged pair-IPA covering every committed-tensor claim,
    #: both data folds AND both zkReLU validity statements (openings.py)
    ipa_agg: ipa.IpaProof
    n_steps: int = 1

    def size_bytes(self) -> int:
        """Exact wire size: the length of the canonical byte encoding
        (`proofio.encode_proof`), not an in-memory estimate."""
        from repro_torch.core.pipeline.proofio import encode_proof
        return len(encode_proof(self))


def _as_pipeline_keys(keys) -> PipelineKeys:
    """Accept either a raw `PipelineKeys` or a `ProvingKey` wrapper (the
    `compile()` artifact) everywhere the prover takes key material."""
    if isinstance(keys, PipelineKeys):
        return keys
    inner = getattr(keys, "keys", None)
    if isinstance(inner, PipelineKeys):
        return inner
    raise TypeError(f"expected PipelineKeys or ProvingKey, got {keys!r}")


class SessionProver:
    """Two-phase prover over a stacked witness: commit, then prove."""

    def __init__(self, keys, rng: np.random.Generator,
                 profile: Optional[PhaseProfile] = None):
        self.keys = _as_pipeline_keys(keys)
        self.cfg = self.keys.cfg
        self.rng = rng
        self.profile = profile if profile is not None else PhaseProfile()

    # -- commitment phase --------------------------------------------------
    def commit(self, sw: StackedWitness) -> SessionCommitments:
        with self.profile.phase("commit"):
            return self._commit(sw)

    def _commit(self, sw: StackedWitness) -> SessionCommitments:
        cfg, keys, rng = self.cfg, self.keys, self.rng
        schema = cfg.graph.commit_slots
        self.sw = sw
        self.tabs = build_field_tables(sw)
        self.blinds = {spec.name: rand_scalar(rng) for spec in schema}
        self.x_blinds = [rand_scalar(rng) for _ in sw.x]

        # All multi-exponentiation commitments batch into TWO row-batched
        # MSMs: one for the T*B per-sample data rows, one for the stacked
        # slot tensors in schema order (each row's blind rides as an
        # extra (h, blind) MSM term).  Bit-matrix slots (B_{Q-1}) commit
        # under the zkReLU G-column basis instead.
        com_x = group.decode_group_many(pedersen.commit_many(
            [(keys.kx, self.tabs.x_tabs[i], b)
             for i, b in enumerate(self.x_blinds)]))
        msm_specs = [s for s in schema if not s.bits]
        msm_coms = group.decode_group_many(pedersen.commit_many(
            [(keys.slot_key(s), self.tabs.tabs[s.name],
              self.blinds[s.name]) for s in msm_specs]))
        slot_coms = {s.name: c for s, c in zip(msm_specs, msm_coms)}
        for s in schema:
            if s.bits:
                slot_coms[s.name] = group.decode_group(pedersen.commit_bits(
                    keys.k_bq, sw.tensors[s.name],
                    self.blinds[s.name]))
        slot_coms = {s.name: slot_coms[s.name] for s in schema}

        self.aux_bits = zkrelu.build_aux_bits(
            sw.zpp_s, sw.gap_s, sw.bq_s, sw.rz_s, sw.rga_s,
            cfg.q_bits, cfg.r_bits)
        vcoms, self.vblinds = zkrelu.commit_validity(keys.validity,
                                                     self.aux_bits, rng)
        self.coms = SessionCommitments(x=com_x, slots=slot_coms,
                                       validity=vcoms)
        return self.coms

    # -- interactive phase (Fiat-Shamir) -----------------------------------
    def prove(self, transcript: Transcript) -> AggregatedProof:
        cfg, keys, rng = self.cfg, self.keys, self.rng
        prof = self.profile
        t = transcript
        with prof.phase("challenges"):
            t.absorb_ints(b"coms", self.coms.as_ints())
            ch = ChallengeSchedule.draw(t, cfg)

            op: Dict[str, int] = {}
            e_pi1, e_pi2, e_pi3 = openings_mod.initial_claims(
                cfg, self.tabs, ch, op, t)
        with prof.phase("matmul"):
            mat = matmul_mod.prove(cfg, self.tabs, ch, t,        # step (a)
                                   prof=prof)
        with prof.phase("anchor"):
            anc = anchor_mod.prove(cfg, self.tabs, ch, mat, t)   # step (b)
        with prof.phase("openings"):
            ipa_agg = openings_mod.prove(                        # step (c)
                cfg, keys, self.tabs, self.blinds, self.x_blinds,
                self.aux_bits, self.vblinds, ch, mat, anc, op,
                e_pi1, e_pi2, e_pi3, t, rng, prof=prof)

        return AggregatedProof(
            coms=self.coms, openings=op,
            sc_fwd=mat.fams["fwd"].scs, sc_bwd=mat.fams["bwd"].scs,
            sc_gw=mat.fams["gw"].scs, sc_anchor=anc.sc_anchor,
            fwd_finals=mat.fams["fwd"].finals,
            bwd_finals=mat.fams["bwd"].finals,
            gw_finals=mat.fams["gw"].finals,
            fwd_claims=list(mat.fams["fwd"].claims),
            bwd_claims=list(mat.fams["bwd"].claims),
            gw_claims=list(mat.fams["gw"].claims),
            anchor_finals=anc.anchor_finals,
            ipa_agg=ipa_agg, n_steps=cfg.n_steps)


class ProofSession:
    """Streaming front end: add step witnesses as training progresses,
    then emit the single aggregated proof for the window."""

    def __init__(self, keys,
                 rng: Optional[np.random.Generator] = None,
                 label: bytes = b"zkdl"):
        self.keys = _as_pipeline_keys(keys)
        self.cfg = self.keys.cfg
        self.rng = rng if rng is not None else np.random.default_rng()
        self.label = label
        self._steps: List[StepWitness] = []
        #: per-phase wall-clock profile of the most recent prove() call
        self.last_profile: Optional[PhaseProfile] = None

    @property
    def n_pending(self) -> int:
        return len(self._steps)

    @property
    def is_full(self) -> bool:
        return len(self._steps) >= self.cfg.n_steps

    def add_step(self, wit: StepWitness) -> int:
        """Queue one batch-update witness; returns its step index."""
        if self.is_full:
            raise ValueError(
                f"session already holds {self.cfg.n_steps} steps; "
                "prove() and start a new session")
        self._steps.append(wit)
        return len(self._steps) - 1

    def prove(self) -> AggregatedProof:
        """Stack the queued witnesses and emit the aggregated proof."""
        prof = PhaseProfile()
        t0 = time.perf_counter()
        with prof.phase("stack"):
            sw = stack_witnesses(self._steps, self.cfg)
        prof.counts = proof_counts(self.cfg)
        prover = SessionProver(self.keys, self.rng, profile=prof)
        prover.commit(sw)
        proof = prover.prove(Transcript(self.label))
        prof.total_s = time.perf_counter() - t0
        self.last_profile = prof
        return proof

    def verify(self, proof: AggregatedProof) -> bool:
        from repro_torch.core.pipeline.verifier import verify_session
        return verify_session(self.keys, proof, label=self.label)


def prove_session(keys: PipelineKeys, wits: List[StepWitness],
                  rng: np.random.Generator,
                  label: bytes = b"zkdl") -> AggregatedProof:
    """One-shot helper: aggregate `wits` (length cfg.n_steps) -> proof."""
    session = ProofSession(keys, rng, label=label)
    for w in wits:
        session.add_step(w)
    return session.prove()
