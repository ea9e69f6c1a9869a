"""Step (b): the anchor sumcheck -- generalized eq. (27) over the stacked
(elem, node, step) hypercube.

Every claim on the uncommitted tensors A^{l,t} / G_Z^{l,t} produced by
the step-(a) bucket sumchecks is random-linearly combined (coefficients
`AnchorCoefs`) and reduced, through ONE degree-3 sumcheck over all
log2(d_stack) = log2(d_slot) + log2(l_pad) + log2(t_pad) variables, to
claims on the committed auxiliary tensors at a single point u_star.
Aggregating T steps therefore costs log2(t_pad) extra rounds -- not T
extra proofs -- and heterogeneous layers cost nothing extra at all: a
claim at a narrow node's point is embedded into its slot by zero-
extending the point (`pad_point`), so the same batching table handles
every shape.

The public batching tables pa / pg are sums of Kronecker products of
sparse slot-axis coefficient vectors with expanded claim points, grouped
by distinct point (a uniform graph has exactly one fwd/gw/bwd point, so
the seed's two-term tables fall out unchanged); the verifier
re-evaluates them at u_star in O(#claims * log d) host work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.field import FQ, add, sub
from repro_torch.core.mle import (expand_point, heval_point_product,
                            hexpand_point)
from repro_torch.core.sumcheck import (SumcheckProof, sumcheck_prove,
                                       sumcheck_verify)
from repro_torch.core.transcript import Transcript
from repro_torch.core.pipeline import matmul
from repro_torch.core.pipeline.challenges import (AnchorCoefs,
                                                  ChallengeSchedule,
                                                  instance_slices, pad_point)
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.tables import (kron, log2_exact, weight_table,
                                              wt_eval)
from repro_torch.core.pipeline.witness import FieldTables

Q_MOD = FQ.modulus


@dataclasses.dataclass(frozen=True)
class AnchorClaim:
    """One step-(a) claim on an uncommitted activation / gradient tensor:
    its aux slot(s), its element point (in the tensor's own variables),
    the drawn batching coefficient, and where its value lives in the
    bucket sumcheck finals (family, layer, left/right index).

    ``slots`` has one entry for a chain operand; a residual-sum operand
    lists every producer slot — the claimed sumcheck value is then
    A1(p) + A2(p), matched on the table side by the SAME coefficient on
    each producer's slot selector (linear split, no extra transcript)."""
    slots: Tuple[int, ...]
    point: Tuple[int, ...]
    coef: int
    family: str
    layer: int
    idx: int
    step: int


def _act_point(cfg: PipelineConfig, ch: ChallengeSchedule,
               points: Dict[str, List[List[int]]], family: str,
               layer: int) -> Tuple[int, ...]:
    """Element point of the ACTIVATION-side operand claim produced by the
    (family, layer) instance: the bound inner point takes the operand's
    free variables, the claim-tensor slices its fixed ones."""
    inst = cfg.graph.instance(family, layer)
    bi, _ = cfg.graph.locate(family, layer)
    w = points[family][bi]
    u_cols, u_rows, _ = instance_slices(inst, ch.glob(family))
    if family == "fwd":     # A^{layer-1}(u_rows, w): cols bound at w
        return tuple(w) + tuple(u_rows)
    if family == "bwd":     # G_Z^{layer+1}(u_rows, w)
        return tuple(w) + tuple(u_rows)
    # gw left (idx 0): G_Z^layer(w, u_rows); right (idx 1): A^{layer-1}(w, u_cols)
    raise AssertionError("gw handled by _gw_point")


def _gw_point(cfg: PipelineConfig, ch: ChallengeSchedule,
              points: Dict[str, List[List[int]]], layer: int,
              idx: int) -> Tuple[int, ...]:
    inst = cfg.graph.instance("gw", layer)
    bi, _ = cfg.graph.locate("gw", layer)
    w3 = points["gw"][bi]
    u_cols, u_rows, _ = instance_slices(inst, ch.glob("gw"))
    # G_W^l rows select G_Z^l columns, G_W^l cols select A^{l-1} columns
    return (tuple(u_rows) if idx == 0 else tuple(u_cols)) + tuple(w3)


def collect_claims(cfg: PipelineConfig, ch: ChallengeSchedule,
                   al: AnchorCoefs, points: Dict[str, List[List[int]]]
                   ) -> Tuple[List[AnchorClaim], List[AnchorClaim]]:
    """(A claims, G_Z claims), in the fixed a1/a2/g1/g2 draw order."""
    g = cfg.graph
    a_claims: List[AnchorClaim] = []
    g_claims: List[AnchorClaim] = []

    def _operand_slots(family: str, layer: int) -> Tuple[int, ...]:
        """Producer slot(s) of the instance's activation operand: a chain
        operand is its own zkrelu slot; a residual sum lists both
        producers (the claim value splits linearly across them)."""
        return g.producer_aux_slots(g.instance(family, layer).a_node)

    for (ti, l), c in al.a1.items():      # operand A of fwd instance l+1
        a_claims.append(AnchorClaim(
            slots=_operand_slots("fwd", l + 1),
            point=_act_point(cfg, ch, points, "fwd", l + 1),
            coef=c, family="fwd", layer=l + 1, idx=0, step=ti))
    for (ti, l), c in al.a2.items():      # operand A of gw instance l+1
        a_claims.append(AnchorClaim(
            slots=_operand_slots("gw", l + 1),
            point=_gw_point(cfg, ch, points, l + 1, 1),
            coef=c, family="gw", layer=l + 1, idx=1, step=ti))
    for (ti, l), c in al.g1.items():      # G_Z^l from bwd instance l-1
        g_claims.append(AnchorClaim(
            slots=(g.aux_slot(g.node_for_layer("zkrelu", l).name),),
            point=_act_point(cfg, ch, points, "bwd", l - 1),
            coef=c, family="bwd", layer=l - 1, idx=0, step=ti))
    for (ti, l), c in al.g2.items():      # G_Z^l from gw instance l
        g_claims.append(AnchorClaim(
            slots=(g.aux_slot(g.node_for_layer("zkrelu", l).name),),
            point=_gw_point(cfg, ch, points, l, 0),
            coef=c, family="gw", layer=l, idx=0, step=ti))
    return a_claims, g_claims


def _group_claims(cfg: PipelineConfig, claims: List[AnchorClaim]
                  ) -> Dict[Tuple[int, ...], Dict[int, int]]:
    """Claims grouped by distinct element point, coefficients summed per
    stacked slot.  Prover table construction and verifier re-evaluation
    MUST use this same grouping, so it is the single shared helper."""
    groups: Dict[Tuple[int, ...], Dict[int, int]] = {}
    for cl in claims:
        w = groups.setdefault(cl.point, {})
        for s in cl.slots:
            slot = cfg.slot(cl.step, s)
            w[slot] = (w.get(slot, 0) + cl.coef) % Q_MOD
    return groups


def _batch_table(cfg: PipelineConfig, claims: List[AnchorClaim], device):
    """Prover-side public batching table over the full stacked cube:
    sum over claims of coef * (slot selector (x) padded point expansion),
    grouped by distinct point so a uniform graph builds exactly the
    seed's Kronecker terms."""
    groups = _group_claims(cfg, claims)
    acc = None
    for point, weights in groups.items():
        term = kron(weight_table(weights, cfg.s_pad, device),
                    expand_point(pad_point(list(point), cfg.la), device))
        acc = term if acc is None else add(FQ, acc, term)
    return acc


def _batch_eval(cfg: PipelineConfig, claims: List[AnchorClaim],
                el: List[int], u_elem: List[int]) -> int:
    """Verifier-side evaluation of the batching table at u_star."""
    acc = 0
    for point, weights in _group_claims(cfg, claims).items():
        acc = (acc + wt_eval(weights, el) * heval_point_product(
            pad_point(list(point), cfg.la), u_elem)) % Q_MOD
    return acc


@dataclasses.dataclass
class AnchorOut:
    sc_anchor: SumcheckProof
    anchor_finals: List[int]
    u_star: List[int]


def prove(cfg: PipelineConfig, tabs: FieldTables, ch: ChallengeSchedule,
          mat: matmul.MatmulOut, t: Transcript) -> AnchorOut:
    points = {fam: mat.fams[fam].points for fam in mat.fams}
    al = AnchorCoefs.draw(t, cfg)
    a_claims, g_claims = collect_claims(cfg, ch, al, points)
    dev = tabs.bq_t.device
    pa = _batch_table(cfg, a_claims, dev)
    pg = _batch_table(cfg, g_claims, dev)
    one_b = sub(FQ, FQ.one, tabs.bq_t)
    anchor_tables = [one_b, tabs.zpp_t, tabs.gap_t, pa, pg]
    anchor_products = [(0, 3, 1), (0, 4, 2)]
    sc_anchor, u_star, anchor_finals = sumcheck_prove(
        anchor_tables, anchor_products, t, b"anchor")
    return AnchorOut(sc_anchor=sc_anchor, anchor_finals=anchor_finals,
                     u_star=u_star)


def verify(cfg: PipelineConfig, proof, ch: ChallengeSchedule,
           points: Dict[str, List[List[int]]],
           t: Transcript) -> List[int]:
    """Checks the anchor sumcheck against the step-(a) finals and the
    public batching tables; returns u_star.  Raises ValueError on
    failure."""
    al = AnchorCoefs.draw(t, cfg)
    a_claims, g_claims = collect_claims(cfg, ch, al, points)

    # LHS: the batched claims assembled from the bucket sumcheck finals
    lhs = 0
    for cl in a_claims + g_claims:
        finals = getattr(proof, f"{cl.family}_finals")
        v = matmul.pair_final(cfg, finals, cl.family, cl.step, cl.layer,
                              cl.idx)
        lhs = (lhs + cl.coef * v) % Q_MOD

    u_star, exp_anchor = sumcheck_verify(
        lhs, proof.sc_anchor, 3, log2_exact(cfg.d_stack), t, b"anchor")
    f_oneb, f_zpp, f_gap, f_pa, f_pg = proof.anchor_finals
    if exp_anchor != (f_oneb * f_pa % Q_MOD * f_zpp
                      + f_oneb * f_pg % Q_MOD * f_gap) % Q_MOD:
        raise ValueError("anchor-final")
    t.absorb_ints(b"anchor/final", proof.anchor_finals)

    # recompute the public batching tables at u_star
    u_elem, u_slot = u_star[: cfg.la], u_star[cfg.la:]
    el = hexpand_point(u_slot)
    if f_pa != _batch_eval(cfg, a_claims, el, u_elem):
        raise ValueError("anchor-public-tables")
    if f_pg != _batch_eval(cfg, g_claims, el, u_elem):
        raise ValueError("anchor-public-tables")
    return u_star


def output_gz_points(cfg: PipelineConfig, ch: ChallengeSchedule,
                     points: Dict[str, List[List[int]]]
                     ) -> Tuple[List[int], List[int]]:
    """The two element points carrying the G_Z^{L,t} claims that bypass
    the anchor and discharge through the eq. (32) loss-layer reduction:
    pt_b from the bwd instance of pair L-1, pt_w from the gw instance of
    layer L.  Both span log2(batch * padded output width) variables."""
    L = cfg.n_layers
    pt_b = list(_act_point(cfg, ch, points, "bwd", L - 1))
    pt_w = list(_gw_point(cfg, ch, points, L, 0))
    return pt_b, pt_w
