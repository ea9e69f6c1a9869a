"""Challenge schedule for the staged pipeline (one draw, all stages).

Every challenge is drawn from the shared Fiat-Shamir transcript in a
fixed order; the prover and the standalone verifier call the same
``draw`` classmethods at the same transcript positions.

With heterogeneous layer shapes there is no single (row, col) split any
more: each relation family draws ONE global element point spanning its
slot area (``glob_f`` / ``glob_b`` / ``glob_w``), and every relation
instance reads its own row/column coordinates as SLICES of that vector
(`MatmulInstance.{cols,rows,pad} -> instance_slices`), with the unused
high variables contributing the public padding factor
``prod_j (1 - u_j)``.  The draw is split into the seed's named vectors
(u_r/u_c, u_r2/u_c2, u_i/u_j) with sizes that degenerate to the seed's
exact tags and counts on a uniform graph, keeping the uniform transcript
bit-identical.  The slot challenges u_sf/u_sb (aux axis) and u_sw
(weight axis) range over the combined (step, node) axis, which is what
batches all layers of all T steps into each bucket's sumcheck.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.field import FQ
from repro_torch.core.mle import expand_point
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.graph import MatmulInstance
from repro_torch.core.pipeline.tables import kron, log2_exact
from repro_torch.core.transcript import Transcript

Q_MOD = FQ.modulus


@dataclasses.dataclass
class ChallengeSchedule:
    u_r: List[int]; u_c: List[int]       # forward elem point (cols low)
    u_r2: List[int]; u_c2: List[int]     # backward
    u_i: List[int]; u_j: List[int]       # weight-gradient
    u_sf: List[int]; u_sb: List[int]; u_sw: List[int]   # slot axes

    @classmethod
    def draw(cls, t: Transcript, cfg: PipelineConfig) -> "ChallengeSchedule":
        lb, la, lw, lj = cfg.lb, cfg.la, cfg.lw, cfg.lj
        ls = log2_exact(cfg.s_pad)
        lsw = log2_exact(cfg.sw_pad)
        c = lambda tag, n: t.challenge_ints(tag, Q_MOD, n)
        return cls(
            u_r=c(b"u_r", lb), u_c=c(b"u_c", la - lb),
            u_r2=c(b"u_r2", lb), u_c2=c(b"u_c2", la - lb),
            u_i=c(b"u_i", lw - lj), u_j=c(b"u_j", lj),
            u_sf=c(b"u_sf", ls), u_sb=c(b"u_sb", ls), u_sw=c(b"u_sw", lsw))

    # -- global element points (little-endian: cols vary fastest) ---------
    @property
    def glob_f(self) -> List[int]:
        return list(self.u_c) + list(self.u_r)

    @property
    def glob_b(self) -> List[int]:
        return list(self.u_c2) + list(self.u_r2)

    @property
    def glob_w(self) -> List[int]:
        return list(self.u_j) + list(self.u_i)

    def glob(self, family: str) -> List[int]:
        return {"fwd": self.glob_f, "bwd": self.glob_b,
                "gw": self.glob_w}[family]


def instance_slices(inst: MatmulInstance,
                    glob: List[int]) -> Tuple[List[int], List[int], int]:
    """(u_cols, u_rows, padfac) of one instance inside its family's
    global element point: the claim tensor's column variables are the
    low slice, row variables the next, and the remaining high variables
    are bound to zero, contributing the public factor prod (1 - u_j)."""
    lc = log2_exact(inst.claim_cols)
    lr = log2_exact(inst.claim_rows)
    assert lc + lr <= len(glob), (inst, len(glob))
    u_cols = glob[:lc]
    u_rows = glob[lc:lc + lr]
    padfac = 1
    for u in glob[lc + lr:]:
        padfac = padfac * ((1 - u) % Q_MOD) % Q_MOD
    return u_cols, u_rows, padfac


def claim_point(inst: MatmulInstance, glob: List[int]) -> List[int]:
    """The claim tensor's own element point (cols low, rows high)."""
    u_cols, u_rows, _ = instance_slices(inst, glob)
    return list(u_cols) + list(u_rows)


def pad_point(point: List[int], n_vars: int) -> List[int]:
    """Zero-extend a point to the full slot element area: the extra high
    variables select the tensor's low block of the padded slot."""
    assert len(point) <= n_vars
    return list(point) + [0] * (n_vars - len(point))


def pi_bases(ch: ChallengeSchedule, device) -> Tuple:
    """Expanded opening bases at the three matmul points pi1/pi2/pi3."""
    def e(pt):
        return expand_point(pt, device)
    e_pi1 = kron(e(ch.u_sf), kron(e(ch.u_r), e(ch.u_c)))
    e_pi2 = kron(e(ch.u_sb), kron(e(ch.u_r2), e(ch.u_c2)))
    e_pi3 = kron(e(ch.u_sw), kron(e(ch.u_i), e(ch.u_j)))
    return e_pi1, e_pi2, e_pi3


@dataclasses.dataclass
class AnchorCoefs:
    """Random linear combination coefficients batching every A^{l,t} and
    G_Z^{l,t} claim of step (a) into the single anchor sumcheck (the
    generalized eq. 27, now over graph nodes AND steps).  Keys are
    (t, l) with l the claimed tensor's layer index."""
    a1: Dict[Tuple[int, int], int]   # A^l claims from the fwd sumchecks
    a2: Dict[Tuple[int, int], int]   # A^l claims from the gw sumchecks
    g1: Dict[Tuple[int, int], int]   # G_Z^l claims from the bwd sumchecks
    g2: Dict[Tuple[int, int], int]   # G_Z^l claims from the gw sumchecks

    @classmethod
    def draw(cls, t: Transcript, cfg: PipelineConfig) -> "AnchorCoefs":
        T, L = cfg.n_steps, cfg.n_layers
        c = lambda tag, ti, l: t.challenge_int(
            b"%s/%d/%d" % (tag, ti, l), Q_MOD)
        return cls(
            a1={(ti, l): c(b"aA1", ti, l)
                for ti in range(T) for l in range(1, L)},
            a2={(ti, l): c(b"aA2", ti, l)
                for ti in range(T) for l in range(1, L)},
            g1={(ti, l): c(b"aG1", ti, l)
                for ti in range(T) for l in range(2, L)},
            g2={(ti, l): c(b"aG2", ti, l)
                for ti in range(T) for l in range(1, L)})


@dataclasses.dataclass
class WeightDraws:
    """Per-(step, layer) coefficients folding all W claims (and all
    stacked points) into two combined openings of the ONE W commitment."""
    w1: Dict[Tuple[int, int], int]
    w2: Dict[Tuple[int, int], int]

    @classmethod
    def draw(cls, t: Transcript, cfg: PipelineConfig) -> "WeightDraws":
        T, L = cfg.n_steps, cfg.n_layers
        c = lambda tag, ti, l: t.challenge_int(
            b"%s/%d/%d" % (tag, ti, l), Q_MOD)
        return cls(
            w1={(ti, l): c(b"dW1", ti, l)
                for ti in range(T) for l in range(1, L + 1)},
            w2={(ti, l): c(b"dW2", ti, l)
                for ti in range(T) for l in range(1, L)})
