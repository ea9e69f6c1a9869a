"""Step (c): derived claims, the ONE direct-sum opening IPA, and zkReLU
validity.

Everything the anchor reduced to point-claims on COMMITTED tensors is
discharged here:

* the per-step eq. (32) reduction of G_Z^{L,t} to Z''/B/Y claims (the
  loss layer is linear, so the verifier assembles it from openings);
* per committed tensor, ALL of its claims -- across points, graph nodes
  and aggregated steps -- fold into a single (basis, claim) pair via
  <T, b1> + rho <T, b2> = <T, b1 + rho b2>; claims on narrow nodes
  embed into the stacked commitment by zero-extending their points
  (`pad_point`), so heterogeneous shapes share the same fold;
* the per-sample data commitments (Section 4.4) fold homomorphically
  over rows AND steps into two more (basis, claim) blocks;
* then ALL of those per-tensor blocks aggregate into ONE inner-product
  argument: a batching challenge rho weights block k's evaluation vector
  by rho^k, the witness is the direct sum ``a = (+)_k a_k`` over the
  block-concatenated generator basis of `cfg.agg_blocks` (disjoint
  slices of one unified key, zero-padded to the next power of two), and
  the blinds sum;
* the zkReLU validity argument over the full stacked bit matrices RIDES
  THE SAME IPA: the main and remainder eq. (19) statements occupy the
  `cfg.validity_blocks` slices of the merged basis, scaled by the next
  two rho powers (`merged_lambdas`), so a single log(merged_len)-round
  pair IPA plus one sigma finale replaces the K per-tensor arguments
  AND the two former standalone validity IPAs -- one round schedule,
  one L/R chain, 2 log(N) + 5 scalars on the wire instead of
  sum_k (2 log(n_k) + 3) + sum_v (2 log(n_v) + 5).

Soundness of the cross-tensor batching rests on the blocks' generator
slices being pairwise disjoint (see `make_keys`); the one shared slice
-- "x1"/"x2", both derived from the same per-sample data commitments --
is additionally pinned because both fold claims must equal bucket
sumcheck finals the verifier computes itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.field import FQ, add, encode_ints, from_mont, mont_mul
from repro_torch.core import group, ipa, zkrelu
from repro_torch.core.mle import (enc, enc_vec, expand_point, fdot, fdot_many,
                            hexpand_point, weighted_sum)
from repro_torch.core.transcript import Transcript
from repro_torch.core.pipeline import matmul
from repro_torch.core.pipeline import profile as profile_mod
from repro_torch.core.pipeline.anchor import output_gz_points
from repro_torch.core.pipeline.challenges import (ChallengeSchedule,
                                                  WeightDraws, instance_slices,
                                                  pad_point, pi_bases)
from repro_torch.core.pipeline.config import PipelineConfig, PipelineKeys
from repro_torch.core.pipeline.tables import (dec_scalar, dec_scalars, kron,
                                        kron_many, weight_table)
from repro_torch.core.pipeline.witness import FieldTables

Q_MOD = FQ.modulus

# canonical per-step opening-claim names for the eq. (32) reduction
GZ_TOP_KEYS = ("zL_b", "bL_b", "y_b", "zL_w", "bL_w", "y_w")


def gz_top_keys(cfg: PipelineConfig) -> List[str]:
    return [f"{k}/{t}" for t in range(cfg.n_steps) for k in GZ_TOP_KEYS]


def initial_claims(cfg: PipelineConfig, tabs: FieldTables,
                   ch: ChallengeSchedule, op: Dict[str, int],
                   t: Transcript) -> tuple:
    """Openings a1..a6 of the stacked aux tensors at pi1/pi2/pi3."""
    e_pi1, e_pi2, e_pi3 = pi_bases(ch, tabs.zpp_t.device)
    op["a1"] = dec_scalar(fdot(tabs.zpp_t, e_pi1))
    op["a2"] = dec_scalar(fdot(tabs.bq_t, e_pi1))
    op["a3"] = dec_scalar(fdot(tabs.rz_t, e_pi1))
    op["a4"] = dec_scalar(fdot(tabs.gap_t, e_pi2))
    op["a5"] = dec_scalar(fdot(tabs.rga_t, e_pi2))
    op["a6"] = dec_scalar(fdot(tabs.gw_t, e_pi3))
    t.absorb_ints(b"op1", [op[k] for k in ("a1", "a2", "a3",
                                           "a4", "a5", "a6")])
    return e_pi1, e_pi2, e_pi3


def gz_top_bases(cfg: PipelineConfig, pt_b: List[int], pt_w: List[int],
                 device):
    """Per-step bases selecting the output node's slot of the stacked
    aux tensors at pt_b / pt_w, plus the per-step selectors on the
    stacked labels (whose per-step area is the output node's own padded
    size, so the label points need no slot padding).

    Returns four (T, n) stacks (index [ti] for one step's basis); the
    T Kronecker products per point batch into one `kron_many` dispatch
    over a stacked one-hot selector matrix."""
    g = cfg.graph
    T = cfg.n_steps
    out_slot = g.aux_slot(g.node_for_layer("zkrelu", cfg.n_layers).name)
    e_b = expand_point(pad_point(pt_b, cfg.la), device)
    e_w = expand_point(pad_point(pt_w, cfg.la), device)
    e_b_y = expand_point(pt_b, device)
    e_w_y = expand_point(pt_w, device)
    sel_slot = np.zeros((T, cfg.s_pad), dtype=np.int64)
    sel_t = np.zeros((T, cfg.t_pad), dtype=np.int64)
    for t in range(T):
        sel_slot[t, cfg.slot(t, out_slot)] = 1
        sel_t[t, t] = 1
    eL = encode_ints(FQ, sel_slot, device=device)
    e_t = encode_ints(FQ, sel_t, device=device)
    return (kron_many(eL, e_b), kron_many(eL, e_w),
            kron_many(e_t, e_b_y), kron_many(e_t, e_w_y))


def w_opening(cfg: PipelineConfig, dlt: WeightDraws, ch: ChallengeSchedule,
              points: Dict[str, List[List[int]]],
              fwd_finals: List[List[int]], bwd_finals: List[List[int]],
              device):
    """Combined bases/claims folding every W^{l,t} claim into two
    openings of the single stacked-W commitment.  Each claim's point is
    the bucket's bound inner point plus the instance's own slices, zero-
    extended to the common weight-slot area; claims sharing a point are
    grouped into one Kronecker term (a uniform graph gives one group)."""
    g = cfg.graph

    def _combine(draws, family, w_layer_of, pair_layer_of, final_idx,
                 finals, point_of):
        groups: Dict[tuple, Dict[int, int]] = {}
        claim = 0
        for (ti, l), c in draws.items():
            mm = g.node_for_layer("qmatmul", w_layer_of(l))
            slot = cfg.wslot(ti, g.weight_slot(mm.name))
            pt = point_of(w_layer_of(l))
            w = groups.setdefault(pt, {})
            w[slot] = (w.get(slot, 0) + c) % Q_MOD
            claim = (claim + c * matmul.pair_final(
                cfg, finals, family, ti, pair_layer_of(l),
                final_idx)) % Q_MOD
        base = None
        for pt, weights in groups.items():
            term = kron(weight_table(weights, cfg.sw_pad, device),
                        expand_point(pad_point(list(pt), cfg.lw), device))
            base = term if base is None else add(FQ, base, term)
        return base, claim

    def _fwd_w_point(lyr):
        inst = cfg.graph.instance("fwd", lyr)
        bi, _ = cfg.graph.locate("fwd", lyr)
        u_cols, _, _ = instance_slices(inst, ch.glob_f)
        return tuple(u_cols) + tuple(points["fwd"][bi])

    def _bwd_w_point(lyr):
        # W^{lyr} read by the bwd instance of pair lyr-1: rows fixed at
        # the pair's column slice, columns bound by the bucket sumcheck
        inst = cfg.graph.instance("bwd", lyr - 1)
        bi, _ = cfg.graph.locate("bwd", lyr - 1)
        u_cols, _, _ = instance_slices(inst, ch.glob_b)
        return tuple(points["bwd"][bi]) + tuple(u_cols)

    b_w1, cl_w1 = _combine(dlt.w1, "fwd", lambda l: l, lambda l: l, 1,
                           fwd_finals, _fwd_w_point)
    b_w2, cl_w2 = _combine(dlt.w2, "bwd", lambda l: l + 1, lambda l: l, 1,
                           bwd_finals, _bwd_w_point)
    return b_w1, b_w2, cl_w1, cl_w2


def _combine_claims(t: Transcript, name: str, claims_pts):
    """Fold several (public vector, claim) pairs for one tensor into one
    (vector, claim) via transcript powers of rho.  The vector side is a
    single `weighted_sum` dispatch over the stacked bases."""
    rho = t.challenge_int(b"rho/" + name.encode(), Q_MOD)
    coefs, combined_claim, rpow = [], 0, 1
    for _, claim in claims_pts:
        coefs.append(rpow)
        combined_claim = (combined_claim + rpow * claim) % Q_MOD
        rpow = rpow * rho % Q_MOD
    stack = torch.stack([b for b, _ in claims_pts])
    combined_b = weighted_sum(stack, enc_vec(coefs, stack.device))
    return combined_b, combined_claim


def x_fold_openings(cfg: PipelineConfig, ch: ChallengeSchedule,
                    points: Dict[str, List[List[int]]],
                    fwd_finals: List[List[int]],
                    gw_finals: List[List[int]]):
    """The two cross-step data-opening specs: (tag, row point, column
    point, per-step claims) for the layer-1 instances touching the input
    node.  Per-step claims are batched with a rho challenge on top of
    the per-row fold, so all T*B per-sample commitments collapse into
    ONE commitment fold per tag."""
    T = cfg.n_steps
    f_inst = cfg.graph.instance("fwd", 1)
    f_bi, _ = cfg.graph.locate("fwd", 1)
    _, f_rows, _ = instance_slices(f_inst, ch.glob_f)
    g_inst = cfg.graph.instance("gw", 1)
    g_bi, _ = cfg.graph.locate("gw", 1)
    g_cols, _, _ = instance_slices(g_inst, ch.glob_w)
    return (
        ("x1", f_rows, points["fwd"][f_bi],
         [matmul.pair_final(cfg, fwd_finals, "fwd", t, 1, 0)
          for t in range(T)]),
        ("x2", points["gw"][g_bi], g_cols,
         [matmul.pair_final(cfg, gw_finals, "gw", t, 1, 1)
          for t in range(T)]),
    )


def _x_coefs(cfg: PipelineConfig, t: Transcript, tag: str, row_pt,
             claims: List[int]):
    """Per-(step, sample) fold coefficients rho^t * e_row[i] plus the
    combined claim; shared by prover and verifier."""
    e_row = hexpand_point(row_pt)
    rho = t.challenge_int(b"rho/" + tag.encode(), Q_MOD)
    coefs, combined_claim, rpow = [], 0, 1
    for ti in range(cfg.n_steps):
        coefs.extend(rpow * e_row[i] % Q_MOD for i in range(cfg.batch))
        combined_claim = (combined_claim + rpow * claims[ti]) % Q_MOD
        rpow = rpow * rho % Q_MOD
    return coefs, combined_claim


# ---------------------------------------------------------------------------
# Direct-sum aggregation of every per-tensor opening into ONE IPA.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AggClaim:
    """One block of the direct-sum opening: a committed tensor's combined
    evaluation vector and claim.  The prover side carries the witness
    table and blind; the verifier side the commitment group element."""
    name: str
    basis: torch.Tensor                     # (block_len,) Montgomery
    claim: int
    table: Optional[torch.Tensor] = None    # prover witness (Montgomery)
    blind: int = 0
    com: Optional[torch.Tensor] = None      # verifier commitment point


def slot_claim_lists(cfg: PipelineConfig, op: Dict[str, int], e_pi1, e_pi2,
                     e_pi3, e_star, f_zpp: int, f_gap: int, v_q1: int,
                     gz_bases) -> Dict[str, list]:
    """The per-tensor (public basis, claim) lists both sides fold with
    `_combine_claims` -- one shared enumeration, so the prover and the
    standalone verifier can never drift apart.  The "w" list (which
    needs the transcript-drawn `WeightDraws`) is appended by the
    caller."""
    T = cfg.n_steps
    b_gzl_b, b_gzl_w, yb_bases, yw_bases = gz_bases
    return {
        "zpp": [(e_pi1, op["a1"]), (e_star, f_zpp)]
        + [(b_gzl_b[ti], op[f"zL_b/{ti}"]) for ti in range(T)]
        + [(b_gzl_w[ti], op[f"zL_w/{ti}"]) for ti in range(T)],
        "bq": [(e_pi1, op["a2"]), (e_star, v_q1)]
        + [(b_gzl_b[ti], op[f"bL_b/{ti}"]) for ti in range(T)]
        + [(b_gzl_w[ti], op[f"bL_w/{ti}"]) for ti in range(T)],
        "rz": [(e_pi1, op["a3"]), (e_star, op["a7"])],
        "gap": [(e_pi2, op["a4"]), (e_star, f_gap)],
        "rga": [(e_pi2, op["a5"]), (e_star, op["a8"])],
        "gw": [(e_pi3, op["a6"])],
        "y": [(yb_bases[ti], op[f"y_b/{ti}"]) for ti in range(T)]
        + [(yw_bases[ti], op[f"y_w/{ti}"]) for ti in range(T)],
    }


def direct_sum(cfg: PipelineConfig, t: Transcript,
               blocks: Dict[str, AggClaim]):
    """Draw the batching challenge and assemble the aggregated statement:
    block k's basis scales by rho^k (so the single inner product equals
    the rho-weighted sum of the per-block claims), blocks concatenate at
    their `cfg.agg_blocks` offsets, and the tail zero-pads to the
    power-of-two `cfg.agg_len`."""
    rho = t.challenge_int(b"rho/agg", Q_MOD)
    parts, claim, rpow = [], 0, 1
    for name, _, n in cfg.agg_blocks:
        blk = blocks[name]
        assert blk.basis.shape[0] == n, (name, blk.basis.shape, n)
        parts.append(mont_mul(FQ, blk.basis, enc(rpow)))
        claim = (claim + rpow * blk.claim) % Q_MOD
        rpow = rpow * rho % Q_MOD
    b_agg = _pad_concat(cfg, parts)
    return b_agg, claim, rho


def _pad_concat(cfg: PipelineConfig, parts) -> torch.Tensor:
    total = sum(p.shape[0] for p in parts)
    pad = cfg.agg_len - total
    if pad:
        parts = list(parts) + [parts[0].new_zeros(pad)]
    return torch.cat(parts)


def stacked_witness(cfg: PipelineConfig,
                    blocks: Dict[str, AggClaim]) -> torch.Tensor:
    """Prover side: the direct-sum witness a = (+)_k a_k, zero-padded
    (zero IS the Montgomery encoding of zero, so pad generators never
    contribute)."""
    return _pad_concat(cfg, [blocks[name].table
                             for name, _, _ in cfg.agg_blocks])


def _sub(prof, name: str):
    return profile_mod.subphase(prof, name)


def prover_blocks(cfg: PipelineConfig, tabs: FieldTables,
                  blinds: Dict[str, int], x_blinds: List[int],
                  ch: ChallengeSchedule, mat: matmul.MatmulOut, anc,
                  op: Dict[str, int], e_pi1, e_pi2, e_pi3, t: Transcript):
    """Derived claims, every per-tensor combine and the two data folds:
    the complete prover-side block table of the direct-sum opening, plus
    the zkReLU claim context ``(u_relu, v, v_q1, v_r)``.  Factored out
    of `prove` so tests can pin the value-level parity of the
    aggregation (every block claim is a true inner product of its
    witness, and the aggregated claim is their rho-weighted sum)."""
    T = cfg.n_steps
    points = {fam: mat.fams[fam].points for fam in mat.fams}
    u_star = anc.u_star
    dev = tabs.zpp_t.device
    e_star = expand_point(u_star, dev)
    op["a7"] = dec_scalar(fdot(tabs.rz_t, e_star))
    op["a8"] = dec_scalar(fdot(tabs.rga_t, e_star))
    t.absorb_ints(b"op2", [op["a7"], op["a8"]])
    upp = t.challenge_int(b"upp", Q_MOD)
    u_relu = u_star + [upp]
    f_oneb, f_zpp, f_gap = anc.anchor_finals[:3]
    v = ((1 - upp) * f_zpp + upp * f_gap) % Q_MOD
    v_q1 = (1 - f_oneb) % Q_MOD
    v_r = ((1 - upp) * op["a7"] + upp * op["a8"]) % Q_MOD
    t.absorb_ints(b"vclaims", [v, v_q1, v_r])

    # per-step GZ^{L,t} linear reduction claims (eq. 32): the 6T stacked-
    # tensor evaluations batch into three fdot_many dispatches (one per
    # tensor) and three host transfers instead of 6T of each
    pt_b, pt_w = output_gz_points(cfg, ch, points)
    b_gzl_b, b_gzl_w, yb_bases, yw_bases = gz_top_bases(cfg, pt_b, pt_w,
                                                        dev)
    gzl_bases = torch.cat([b_gzl_b, b_gzl_w])
    zl_vals = dec_scalars(fdot_many(tabs.zpp_t, gzl_bases))
    bl_vals = dec_scalars(fdot_many(tabs.bq_t, gzl_bases))
    y_vals = dec_scalars(fdot_many(tabs.y_t,
                                   torch.cat([yb_bases, yw_bases])))
    for ti in range(T):
        op[f"zL_b/{ti}"] = zl_vals[ti]
        op[f"bL_b/{ti}"] = bl_vals[ti]
        op[f"y_b/{ti}"] = y_vals[ti]
        op[f"zL_w/{ti}"] = zl_vals[T + ti]
        op[f"bL_w/{ti}"] = bl_vals[T + ti]
        op[f"y_w/{ti}"] = y_vals[T + ti]
    t.absorb_ints(b"op3", [op[k] for k in gz_top_keys(cfg)])

    dlt = WeightDraws.draw(t, cfg)
    b_w1, b_w2, cl_w1, cl_w2 = w_opening(
        cfg, dlt, ch, points, mat.fams["fwd"].finals,
        mat.fams["bwd"].finals, dev)
    lists = slot_claim_lists(cfg, op, e_pi1, e_pi2, e_pi3, e_star,
                             f_zpp, f_gap, v_q1,
                             (b_gzl_b, b_gzl_w, yb_bases, yw_bases))
    lists["w"] = [(b_w1, cl_w1), (b_w2, cl_w2)]

    blocks: Dict[str, AggClaim] = {}
    for name, _, _ in cfg.agg_blocks:
        if name in ("x1", "x2"):
            continue
        comb_b, comb_c = _combine_claims(t, name, lists[name])
        blocks[name] = AggClaim(name, comb_b, comb_c,
                                table=tabs.tabs[name],
                                blind=blinds[name])

    # data blocks: per-sample commitments folded over rows AND steps;
    # the T*B-row table fold is ONE weighted_sum dispatch per tag
    x_stack = tabs.x_tabs
    for tag, row_pt, col_pt, claims in x_fold_openings(
            cfg, ch, points, mat.fams["fwd"].finals,
            mat.fams["gw"].finals):
        coefs, combined_claim = _x_coefs(cfg, t, tag, row_pt, claims)
        folded = weighted_sum(x_stack, enc_vec(coefs, dev))
        blind_f = sum(c * xb
                      for c, xb in zip(coefs, x_blinds)) % Q_MOD
        blocks[tag] = AggClaim(tag, expand_point(col_pt, dev),
                               combined_claim, table=folded,
                               blind=blind_f)
    return blocks, (u_relu, v, v_q1, v_r)


def merged_lambdas(cfg: PipelineConfig, rho: int):
    """The validity blocks' batching weights inside the merged opening:
    the open blocks consume rho^0..rho^{K-1}, so the main/remainder
    validity statements take the next two powers.  Their claims enter
    squared (lam^2 c: both witness sides carry lam), so the claim
    monomials rho^{2K} / rho^{2K+2} stay distinct from the open blocks'
    rho^0..rho^{K-1} — the Schwartz-Zippel batching argument is
    unchanged."""
    K = len(cfg.agg_blocks)
    lam1 = pow(rho, K, Q_MOD)
    return lam1, lam1 * rho % Q_MOD


def _merged_pad(cfg: PipelineConfig):
    last = cfg.validity_blocks[-1]
    return cfg.merged_len - (last[1] + last[2])


def prove(cfg: PipelineConfig, keys: PipelineKeys, tabs: FieldTables,
          blinds: Dict[str, int], x_blinds: List[int],
          aux_bits: zkrelu.AuxBits, vblinds, ch: ChallengeSchedule,
          mat: matmul.MatmulOut, anc, op: Dict[str, int],
          e_pi1, e_pi2, e_pi3, t: Transcript, rng, prof=None):
    """Runs the whole of step (c) prover-side; returns the single merged
    pair-IPA proof covering every opening block AND both zkReLU validity
    statements.  ``prof`` (a `PhaseProfile`) attributes the sub-phases
    claim-combine / zkrelu-validity / h-basis / ipa-rounds / sigma."""
    with _sub(prof, "claim-combine"):
        blocks, (u_relu, v, v_q1, v_r) = prover_blocks(
            cfg, tabs, blinds, x_blinds, ch, mat, anc, op,
            e_pi1, e_pi2, e_pi3, t)

    with _sub(prof, "zkrelu-validity"):
        # validity challenges draw BEFORE rho/agg; the a/b tables for
        # both statements come out of one validity_tables dispatch
        st = zkrelu.prove_statements(keys.validity, aux_bits, vblinds,
                                     u_relu, v, v_q1, v_r, t)

    with _sub(prof, "claim-combine"):
        b_agg, claim_agg, rho = direct_sum(cfg, t, blocks)
        a_agg = stacked_witness(cfg, blocks)
        blind_agg = sum(blk.blind for blk in blocks.values()) % Q_MOD
        lam1, lam2 = merged_lambdas(cfg, rho)
        l1, l2 = enc(lam1), enc(lam2)
        pad = _merged_pad(cfg)
        zeros = a_agg.new_zeros(pad)
        a_hat = torch.cat([a_agg, mont_mul(FQ, st.a_main, l1),
                           mont_mul(FQ, st.a_rem, l2), zeros])
        b_hat = torch.cat([b_agg, mont_mul(FQ, st.b_main, l1),
                           mont_mul(FQ, st.b_rem, l2), zeros])
        ones = a_agg.new_full((cfg.agg_len,), FQ.one)
        pones = a_agg.new_full((pad,), FQ.one)
        w = torch.cat([ones, st.w_main, st.w_rem, pones])
        claim = (claim_agg + lam1 * lam1 % Q_MOD * st.claim_main
                 + lam2 * lam2 % Q_MOD * st.claim_rem) % Q_MOD
        blind = (blind_agg + lam1 * st.blind_main
                 + lam2 * st.blind_rem) % Q_MOD

    if cfg.merged_len <= zkrelu.POW_TABLE_MAX_ELEMS:
        stmt = (keys.g_merged, None, keys.validity.h_blind, a_hat, b_hat,
                blind, claim,
                (keys.g_merged_table, keys.h_merged, keys.h_merged_table, w))
    else:
        with _sub(prof, "h-basis"):
            hh = group.g_pow(keys.h_merged, from_mont(FQ, w))
        stmt = (keys.g_merged, hh, keys.validity.h_blind, a_hat, b_hat,
                blind, claim)
    (ipa_agg,) = ipa.pair_prove_many([stmt], t, rng, prof=prof)
    return ipa_agg


def verify(cfg: PipelineConfig, keys: PipelineKeys, proof, coms,
           ch: ChallengeSchedule, points: Dict[str, List[List[int]]],
           u_star, e_pi1, e_pi2, e_pi3, t: Transcript) -> None:
    """Verifier side of step (c).  Raises ValueError naming the first
    failing check."""
    T = cfg.n_steps
    op = proof.openings
    two_q1 = pow(2, cfg.q_bits - 1, Q_MOD)
    dev = keys.device
    e_star = expand_point(u_star, dev)
    f_oneb, f_zpp, f_gap = proof.anchor_finals[:3]

    t.absorb_ints(b"op2", [op["a7"], op["a8"]])
    upp = t.challenge_int(b"upp", Q_MOD)
    u_relu = u_star + [upp]
    v = ((1 - upp) * f_zpp + upp * f_gap) % Q_MOD
    v_q1 = (1 - f_oneb) % Q_MOD
    v_r = ((1 - upp) * op["a7"] + upp * op["a8"]) % Q_MOD
    t.absorb_ints(b"vclaims", [v, v_q1, v_r])
    t.absorb_ints(b"op3", [op[k] for k in gz_top_keys(cfg)])

    # per-step GZ^{L,t} linear checks (eq. 32)
    L = cfg.n_layers
    for ti in range(T):
        gzl_b = (op[f"zL_b/{ti}"] - two_q1 * op[f"bL_b/{ti}"]
                 - op[f"y_b/{ti}"]) % Q_MOD
        if matmul.pair_final(cfg, proof.bwd_finals, "bwd", ti, L - 1,
                             0) != gzl_b:
            raise ValueError("gzL-bwd")
        gzl_w = (op[f"zL_w/{ti}"] - two_q1 * op[f"bL_w/{ti}"]
                 - op[f"y_w/{ti}"]) % Q_MOD
        if matmul.pair_final(cfg, proof.gw_finals, "gw", ti, L,
                             0) != gzl_w:
            raise ValueError("gzL-gw")

    pt_b, pt_w = output_gz_points(cfg, ch, points)
    b_gzl_b, b_gzl_w, yb_bases, yw_bases = gz_top_bases(cfg, pt_b, pt_w,
                                                        dev)

    dlt = WeightDraws.draw(t, cfg)
    b_w1, b_w2, cl_w1, cl_w2 = w_opening(cfg, dlt, ch, points,
                                         proof.fwd_finals,
                                         proof.bwd_finals, dev)
    lists = slot_claim_lists(cfg, op, e_pi1, e_pi2, e_pi3, e_star,
                             f_zpp, f_gap, v_q1,
                             (b_gzl_b, b_gzl_w, yb_bases, yw_bases))
    lists["w"] = [(b_w1, cl_w1), (b_w2, cl_w2)]

    blocks: Dict[str, AggClaim] = {}
    for name, _, _ in cfg.agg_blocks:
        if name in ("x1", "x2"):
            continue
        comb_b, comb_c = _combine_claims(t, name, lists[name])
        blocks[name] = AggClaim(
            name, comb_b, comb_c,
            com=group.encode_group(coms.slots[name], dev))

    # data blocks: fold the per-sample commitments homomorphically
    com_pts = torch.stack([group.encode_group(ci, dev) for ci in coms.x])
    for tag, row_pt, col_pt, claims in x_fold_openings(
            cfg, ch, points, proof.fwd_finals, proof.gw_finals):
        coefs, combined_claim = _x_coefs(cfg, t, tag, row_pt, claims)
        com_fold = group.msm(com_pts, group.exps_from_ints(coefs, dev))
        blocks[tag] = AggClaim(tag, expand_point(col_pt, dev), combined_claim,
                               com=com_fold)

    # validity statements: redraw challenges, transform commitments
    # (Algorithm 1) — BEFORE rho/agg, matching the prover's schedule
    ctx = zkrelu.verify_statements(keys.validity, coms.validity,
                                   v, v_q1, v_r, u_relu, t)

    # the merged commitment is the product of every block's commitment
    # (shared blind generator; zero pad witness), times the open
    # region's public H-side factor, times the lam-scaled transformed
    # validity commitments; ONE pair-IPA check replaces everything
    b_agg, claim_agg, rho = direct_sum(cfg, t, blocks)
    com_agg = blocks[cfg.agg_blocks[0][0]].com
    for name, _, _ in cfg.agg_blocks[1:]:
        com_agg = group.g_mul(com_agg, blocks[name].com)
    lam1, lam2 = merged_lambdas(cfg, rho)
    com_hat = group.g_mul(com_agg, group.msm_field(keys.h_open, b_agg))
    com_hat = group.g_mul(com_hat, group.g_pow_int(ctx.com_t, lam1))
    com_hat = group.g_mul(com_hat, group.g_pow_int(ctx.com_tr, lam2))
    claim = (claim_agg + lam1 * lam1 % Q_MOD * ctx.claim_main
             + lam2 * lam2 % Q_MOD * ctx.claim_rem) % Q_MOD
    vtail = cfg.validity_blocks[-1][1] + cfg.validity_blocks[-1][2]
    hh = torch.cat([keys.h_open, ctx.h_prime_main, ctx.h_prime_rem,
                    keys.h_merged[vtail:]])
    if not ipa.pair_verify_many(
            [(keys.g_merged, hh, keys.validity.h_blind, com_hat, claim,
              cfg.merged_len)],
            [proof.ipa_agg], t):
        raise ValueError("open-agg")
