"""Step (a): shape-bucketed batched matmul sumchecks (Fig. 3, eqs 30/33/34).

The seed's three hardcoded fwd/bwd/gw sumchecks are the uniform-width
special case of a general rule: every matmul relation instance of the
layer graph is keyed by its sumcheck table length (padded inner
dimension) and all instances in a bucket — across layers AND aggregated
training steps — share ONE batched sumcheck.  Pair (t, instance) enters
with the public coefficient

    e(u_slot)[slot(t, node)] * padfac(instance)

where padfac is the zero-padding factor of the instance's claim tensor
inside its slot (1 for the widest shape).  The per-bucket initial claims
sum to the family target derived from the stacked-commitment openings
a1..a6; with more than one bucket the prover transmits the split (it is
redundant for a single bucket, so uniform graphs keep the exact seed
transcript).

Final-value indexing (shared with the anchor stage and the verifier):
within bucket b of a family, pair (t, pos) -> tables
[left, right] at indices [2p, 2p+1] with p = t * len(b.instances) + pos.
`MatmulOut.final` / `LayerGraph.locate` hide this arithmetic from the
other stages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.field import FQ
from repro_torch.core.mle import fdot, hexpand_point
from repro_torch.core.sumcheck import (SumcheckProof, combine_final,
                                 sumcheck_prove, sumcheck_verify)
from repro_torch.core.transcript import Transcript
from repro_torch.core.pipeline.challenges import (ChallengeSchedule,
                                                  instance_slices)
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.graph import MatmulInstance
from repro_torch.core.pipeline.tables import dec_scalar, fix_cols, fix_rows
from repro_torch.core.pipeline.witness import FieldTables

Q_MOD = FQ.modulus

FAMILY_LABELS = {"fwd": b"fwd", "bwd": b"bwd", "gw": b"gw"}


def slot_axis_point(ch: ChallengeSchedule, family: str) -> List[int]:
    return {"fwd": ch.u_sf, "bwd": ch.u_sb, "gw": ch.u_sw}[family]


def _slots_of(cfg: PipelineConfig, inst: MatmulInstance,
              ti: int) -> List[int]:
    if inst.family == "gw":
        return [cfg.wslot(ti, s) for s in inst.claim_slots]
    return [cfg.slot(ti, s) for s in inst.claim_slots]


def bucket_coefs(cfg: PipelineConfig, ch: ChallengeSchedule,
                 bucket) -> List[int]:
    """Public pair coefficients sum_s e(u_slot)[slot(t, s)] * padfac,
    t-major, in the bucket's pair order (identical on both sides of the
    protocol).  The sum over an instance's claim slots is the residual
    backward split: the gradient of A1 + A2 feeds both producers'
    committed gap/rga decompositions, so ONE sumcheck pair carries both
    slot coefficients."""
    e_slot = hexpand_point(slot_axis_point(ch, bucket.family))
    glob = ch.glob(bucket.family)
    out = []
    for ti in range(cfg.n_steps):
        for inst in bucket.instances:
            _, _, padfac = instance_slices(inst, glob)
            c = sum(e_slot[s] for s in _slots_of(cfg, inst, ti)) % Q_MOD
            out.append(c * padfac % Q_MOD)
    return out


def _fix_operands(tabs: FieldTables, inst: MatmulInstance, ti: int,
                  u_cols: List[int], u_rows: List[int]):
    """The two length-`inner` sumcheck tables of one (step, instance)."""
    l = inst.layer
    if inst.family == "fwd":
        # Z^l(u_rows, u_cols) = sum_k A^{l-1}(u_rows, k) W^l(k, u_cols)
        return (fix_rows(tabs.a_tabs[ti][l - 1], u_rows),
                fix_cols(tabs.w_mats[ti][l - 1], u_cols))
    if inst.family == "bwd":
        # G_A^l(u_rows, u_cols) = sum_j G_Z^{l+1}(u_rows, j) W^{l+1}(u_cols, j)
        return (fix_rows(tabs.gz_tabs[ti][l], u_rows),
                fix_rows(tabs.w_mats[ti][l], u_cols))
    # gw: G_W^l(u_rows, u_cols) = sum_b G_Z^l(b, u_rows) A^{l-1}(b, u_cols)
    return (fix_cols(tabs.gz_tabs[ti][l - 1], u_rows),
            fix_cols(tabs.a_tabs[ti][l - 1], u_cols))


@dataclasses.dataclass
class FamilyOut:
    claims: List[int]              # per-bucket initial claims
    scs: List[SumcheckProof]
    finals: List[List[int]]
    points: List[List[int]]        # bound (inner-variable) point per bucket


@dataclasses.dataclass
class MatmulOut:
    fams: Dict[str, FamilyOut]

    def point(self, cfg: PipelineConfig, family: str, layer: int) -> List[int]:
        bi, _ = cfg.graph.locate(family, layer)
        return self.fams[family].points[bi]

    def final(self, cfg: PipelineConfig, family: str, ti: int, layer: int,
              idx: int) -> int:
        """Final value of pair (step ti, layer)'s left (idx=0) or right
        (idx=1) table in its bucket's sumcheck."""
        bi, pos = cfg.graph.locate(family, layer)
        bucket = cfg.graph.buckets[family][bi]
        p = ti * len(bucket.instances) + pos
        return self.fams[family].finals[bi][2 * p + idx]


def pair_final(cfg: PipelineConfig, finals: List[List[int]], family: str,
               ti: int, layer: int, idx: int) -> int:
    """Verifier-side twin of `MatmulOut.final` over raw proof lists."""
    bi, pos = cfg.graph.locate(family, layer)
    bucket = cfg.graph.buckets[family][bi]
    p = ti * len(bucket.instances) + pos
    return finals[bi][2 * p + idx]


def prove(cfg: PipelineConfig, tabs: FieldTables, ch: ChallengeSchedule,
          t: Transcript) -> MatmulOut:
    fams: Dict[str, FamilyOut] = {}
    for fam in ("fwd", "bwd", "gw"):
        label = FAMILY_LABELS[fam]
        buckets = cfg.graph.buckets[fam]
        glob = ch.glob(fam)
        fixed = []                 # per bucket: (tables, products, coefs)
        for bucket in buckets:
            tables, products = [], []
            for ti in range(cfg.n_steps):
                for inst in bucket.instances:
                    u_cols, u_rows, _ = instance_slices(inst, glob)
                    left, right = _fix_operands(tabs, inst, ti,
                                                u_cols, u_rows)
                    p = len(tables)
                    tables += [left, right]
                    products.append((p, p + 1))
            fixed.append((tables, products, bucket_coefs(cfg, ch, bucket)))

        # the per-bucket claim split is only transmitted (and only
        # needed) when the family has more than one bucket; a single
        # bucket's claim is implicit in the a1..a6 openings
        claims = []
        if len(buckets) > 1:
            for tables, products, coefs in fixed:
                acc = 0
                for (i, j), c in zip(products, coefs):
                    acc = (acc + c * dec_scalar(fdot(tables[i],
                                                     tables[j]))) % Q_MOD
                claims.append(acc)
            t.absorb_ints(label + b"/claims", claims)

        out = FamilyOut(claims=claims, scs=[], finals=[], points=[])
        for tables, products, coefs in fixed:
            sc, w, finals = sumcheck_prove(tables, products, t, label,
                                           coefs=coefs)
            out.scs.append(sc)
            out.points.append(w)
            out.finals.append(finals)
        fams[fam] = out
    return MatmulOut(fams=fams)


def family_targets(cfg: PipelineConfig, op: Dict[str, int]) -> Dict[str, int]:
    """Family claim totals from the stacked-commitment openings: the
    opening points pi1/pi2/pi3 span the whole (elem, node, step) cube,
    so the linear zkReLU decompositions (3)/(5) turn a1..a6 into the
    batched matmul claims summed over every bucket."""
    two_r = pow(2, cfg.r_bits, Q_MOD)
    two_qr1 = pow(2, cfg.q_bits + cfg.r_bits - 1, Q_MOD)
    return {
        "fwd": (two_r * op["a1"] - two_qr1 * op["a2"] + op["a3"]) % Q_MOD,
        "bwd": (two_r * op["a4"] + op["a5"]) % Q_MOD,
        "gw": op["a6"] % Q_MOD,
    }


def verify(cfg: PipelineConfig, proof, op, ch: ChallengeSchedule,
           t: Transcript) -> Dict[str, List[List[int]]]:
    """Checks every bucket sumcheck; returns the bound points per family.

    Raises ValueError on any inconsistency (caught by the caller)."""
    targets = family_targets(cfg, op)
    points: Dict[str, List[List[int]]] = {}
    for fam in ("fwd", "bwd", "gw"):
        label = FAMILY_LABELS[fam]
        buckets = cfg.graph.buckets[fam]
        scs = getattr(proof, f"sc_{fam}")
        finals = getattr(proof, f"{fam}_finals")
        claims = getattr(proof, f"{fam}_claims")
        if len(scs) != len(buckets) or len(finals) != len(buckets):
            raise ValueError(f"{fam}-bucket-count")
        if len(buckets) == 1:
            if claims:
                raise ValueError(f"{fam}-claim-split")   # must be implicit
            claims = [targets[fam]]
        else:
            if len(claims) != len(buckets):
                raise ValueError(f"{fam}-claim-split")
            if sum(claims) % Q_MOD != targets[fam]:
                raise ValueError(f"{fam}-claim-split")
            t.absorb_ints(label + b"/claims", claims)
        points[fam] = []
        for bi, bucket in enumerate(buckets):
            n_pairs = cfg.n_steps * len(bucket.instances)
            products = [(2 * i, 2 * i + 1) for i in range(n_pairs)]
            w, expected = sumcheck_verify(claims[bi], scs[bi], 2,
                                          bucket.rounds, t, label)
            if expected != combine_final(products, finals[bi],
                                         coefs=bucket_coefs(cfg, ch, bucket)):
                raise ValueError(f"{fam}-final")
            t.absorb_ints(label + b"/final", finals[bi])
            points[fam].append(w)
    return points
