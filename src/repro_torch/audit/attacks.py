"""Structured adversaries against the v3 proof format.

Every attack is a named transformation over ``(witness trajectory,
ProvingKey, proof bytes, vk)`` that produces a *self-consistent* forgery
— commitments recomputed, transcripts replayed honestly over doctored
state — and the battery's contract is that ``verify_bytes`` rejects all
of them.  Random byte flips (the fuzz suite) exercise the decoder;
these exercise the soundness argument itself:

* ``spoofed-trajectory``: the SecurePoL spoof — fabricate gradients
  that "explain" an arbitrary weight update, then re-prove the rest of
  the trajectory honestly from the spoofed weights.  Every commitment
  is fresh and mutually consistent; only eq. (34) (G_W = G_Z^T A) is a
  lie, so rejection pins the gradient relation, not bookkeeping.
* ``cross-slot``: the PR-5/6 disjoint-slice argument — move claims,
  commitments, lambdas or generator slices between slots of the merged
  one-IPA and re-prove where possible.
* ``replay`` / ``splice``: honest bytes presented under the wrong vk,
  label, or window, or sections grafted between two honest proofs.
* ``validity-forgery``: self-consistent zkReLU table forgeries —
  out-of-range gap aliased into range, flipped bit planes with the
  negated matrix kept consistent.

Attacks that re-run the real prover patch ONLY module-level seams
(``openings.merged_lambdas``, ``zkrelu.build_aux_bits``, the mutable
``slot_keys`` dict) and always restore them; the honest context stays
reusable across the battery.

This is the reference's battery (`repro.audit.attacks`) against the
port's prover and verifier: witnesses are tensors on the proving
device, and every random draw is the reference's host numpy stream,
moved to the device afterwards, so each forgery is the reference's
forgery, byte for byte.  The seams are looked up through their modules
at call time (``openings.merged_lambdas``, ``zkrelu.build_aux_bits``),
so patching the module attribute reaches the prover.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pedersen, zkrelu
from repro_torch.core.pipeline import openings as openings_mod
from repro_torch.core.pipeline import (build_fcnn_graph, compile as zk_compile,
                                       decode_proof, encode_proof,
                                       prove_session, verify_bytes)
from repro_torch.core.pipeline.api import VerifyingKey
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.quantfc import (QuantConfig, sgd_apply,
                                      synthetic_sgd_trajectory_widths,
                                      train_step_witness)


@contextlib.contextmanager
def _patched(obj, name: str, value):
    """Temporarily replace an attribute; ALWAYS restore (a leaked patch
    would poison the honest prover for every later attack)."""
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


@dataclasses.dataclass
class VariantResult:
    variant: str
    rejected: bool
    trace: str = ""


@dataclasses.dataclass
class AttackOutcome:
    name: str
    family: str
    rejected: bool               # True iff EVERY variant was rejected
    variants: List[VariantResult]
    seconds: float

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "family": self.family,
            "rejected": self.rejected,
            "seconds": round(self.seconds, 3),
            "variants": [{"variant": v.variant, "rejected": v.rejected,
                          "trace": v.trace} for v in self.variants],
        }


@dataclasses.dataclass
class AttackContext:
    """One honest proved window plus everything an adversary controls."""
    pk: object
    vk: VerifyingKey
    quant: QuantConfig
    wits: list                    # honest trajectory (NEVER mutated in place)
    widths: tuple
    batch: int
    n_steps: int
    label: bytes
    seed: int
    lr_shift: int
    proof_bytes: bytes
    compile_seconds: float = 0.0
    prove_seconds: float = 0.0
    _second: Optional[Tuple[list, bytes]] = None

    @property
    def cfg(self):
        return self.pk.keys.cfg

    @property
    def device(self) -> torch.device:
        return self.pk.device

    def reprove(self, wits, tag: int) -> bytes:
        rng = np.random.default_rng(self.seed * 1009 + tag)
        return encode_proof(prove_session(self.pk, wits, rng,
                                          label=self.label))

    def second_window(self) -> bytes:
        """A SECOND honest window (fresh data, same pk/vk/label), shared
        by the replay and splice attacks.  Cached: proving is the
        expensive step."""
        if self._second is None:
            wits2 = synthetic_sgd_trajectory_widths(
                self.n_steps, self.widths, self.batch, self.quant,
                seed=self.seed + 1, lr_shift=self.lr_shift,
                device=self.device)
            raw2 = self.reprove(wits2, 999)
            assert verify_bytes(self.vk, raw2, label=self.label), \
                "second honest window must verify"
            self._second = (wits2, raw2)
        return self._second[1]

    def expect_reject(self, variant: str, raw: bytes,
                      vk: Optional[VerifyingKey] = None,
                      label: Optional[bytes] = None) -> VariantResult:
        trace: list = []
        accepted = verify_bytes(vk if vk is not None else self.vk, raw,
                                label=label if label is not None
                                else self.label, trace=trace)
        return VariantResult(variant, rejected=not accepted,
                             trace=str(trace[0]) if trace else "")


def build_context(widths=(4, 4, 4), batch: int = 2, n_steps: int = 2,
                  q_bits: int = 16, r_bits: int = 4, seed: int = 11,
                  label: bytes = b"zkdl", lr_shift: int = 8,
                  warm: bool = False, device=None) -> AttackContext:
    """Compile, draw the reference's synthetic trajectory and prove one
    honest window on ``device`` (default: the card)."""
    widths = tuple(int(w) for w in widths)
    qc = QuantConfig(q_bits=q_bits, r_bits=r_bits)
    graph = build_fcnn_graph(widths, batch=batch)
    t0 = time.perf_counter()
    pk, vk = zk_compile(graph, qc, n_steps=n_steps, warm=warm, device=device)
    t1 = time.perf_counter()
    wits = synthetic_sgd_trajectory_widths(n_steps, widths, batch, qc,
                                           seed=seed, lr_shift=lr_shift,
                                           device=pk.device)
    raw = encode_proof(prove_session(pk, wits, np.random.default_rng(seed),
                                     label=label))
    t2 = time.perf_counter()
    assert verify_bytes(vk, raw, label=label), "honest proof must verify"
    return AttackContext(pk=pk, vk=vk, quant=qc, wits=wits, widths=widths,
                         batch=batch, n_steps=n_steps, label=label,
                         seed=seed, lr_shift=lr_shift, proof_bytes=raw,
                         compile_seconds=t1 - t0, prove_seconds=t2 - t1)


# -- registry ---------------------------------------------------------------

ATTACKS: Dict[str, Callable[[AttackContext], List[VariantResult]]] = {}


def attack(name: str, family: str):
    def deco(fn):
        fn.attack_name = name
        fn.attack_family = family
        ATTACKS[name] = fn
        return fn
    return deco


def run_attack(ctx: AttackContext, name: str) -> AttackOutcome:
    fn = ATTACKS[name]
    t0 = time.perf_counter()
    variants = fn(ctx)
    dt = time.perf_counter() - t0
    return AttackOutcome(name=name, family=fn.attack_family,
                         rejected=bool(variants) and
                         all(v.rejected for v in variants),
                         variants=variants, seconds=dt)


def run_battery(ctx: AttackContext,
                names: Optional[List[str]] = None) -> List[AttackOutcome]:
    return [run_attack(ctx, n) for n in (names or list(ATTACKS))]


# -- trajectory forgeries ---------------------------------------------------

@attack("spoofed_sgd_trajectory", "spoofed-trajectory")
def _spoofed_sgd_trajectory(ctx: AttackContext) -> List[VariantResult]:
    """SecurePoL-style spoof: pick an arbitrary weight target, fabricate
    step-0 gradients G_W = (W - W_target)^T * 2^{lr_shift+R} that
    sgd_apply maps EXACTLY onto the target, then recompute every later
    step honestly from the spoofed weights.  All commitments are fresh
    and self-consistent; only eq. (34) in step 0 is false."""
    qc = ctx.quant
    wits = copy.deepcopy(ctx.wits)
    w0 = wits[0]
    lim = 1 << (qc.q_bits - 1)
    rng = np.random.default_rng(ctx.seed + 977)
    # the reference's host numpy stream, then moved to the weights' device
    target = [torch.clamp(w + torch.as_tensor(
        rng.integers(-3, 4, size=tuple(w.shape)), device=w.device),
        -lim, lim - 1) for w in w0.w]
    # guarantee the spoof actually moves at least one weight
    t00 = int(w0.w[0][0, 0])
    target[0][0, 0] = t00 - 1 if t00 > -lim else t00 + 1
    shift = 1 << (ctx.lr_shift + qc.r_bits)
    forged_gw = [((w - tgt).T * shift).contiguous()
                 for w, tgt in zip(w0.w, target)]
    wits[0] = dataclasses.replace(w0, gw=forged_gw)
    ws = target
    for t in range(1, len(wits)):
        step = wits[t]
        wits[t] = train_step_witness(step.x, step.y, ws, qc,
                                     skips=step.skips)
        ws = sgd_apply(ws, wits[t].gw, ctx.lr_shift, qc)
    raw = ctx.reprove(wits, 1)
    return [ctx.expect_reject("forged-gradient self-consistent reprove",
                              raw)]


@attack("wrong_committed_weights", "wrong-weights")
def _wrong_committed_weights(ctx: AttackContext) -> List[VariantResult]:
    """Honest transcript over tampered W^t: the forged weight is
    committed and opened consistently, but the forward product Z = X W
    it participates in is now false."""
    qc = ctx.quant
    wits = copy.deepcopy(ctx.wits)
    lim = 1 << (qc.q_bits - 1)
    wl = wits[-1].w[0]
    w00 = int(wl[0, 0])
    wl[0, 0] = w00 - 1 if w00 > -lim else w00 + 1
    raw = ctx.reprove(wits, 2)
    return [ctx.expect_reject("tampered final-step weight, honest reprove",
                              raw)]


# -- cross-slot claim swaps (the disjoint-slice argument) -------------------

@attack("cross_slot_commit_swap", "cross-slot-claim-swap")
def _cross_slot_commit_swap(ctx: AttackContext) -> List[VariantResult]:
    forged = decode_proof(ctx.proof_bytes)
    slots = dict(forged.coms.slots)
    slots["rz"], slots["rga"] = slots["rga"], slots["rz"]
    forged.coms.slots = slots
    return [ctx.expect_reject("rz<->rga commitment vectors swapped",
                              encode_proof(forged))]


@attack("cross_slot_claim_swap", "cross-slot-claim-swap")
def _cross_slot_claim_swap(ctx: AttackContext) -> List[VariantResult]:
    """The stronger forgery: relocate the claimed openings ALONG WITH
    the commitments so each claim still 'matches' its commitment.  Only
    the disjointness of the generator slices kills this."""
    forged = decode_proof(ctx.proof_bytes)
    slots = dict(forged.coms.slots)
    slots["rz"], slots["rga"] = slots["rga"], slots["rz"]
    forged.coms.slots = slots
    op = forged.openings
    op["a3"], op["a5"] = op["a5"], op["a3"]
    op["a7"], op["a8"] = op["a8"], op["a7"]
    return [ctx.expect_reject("rz<->rga with relocated claims (a3/a5, "
                              "a7/a8)", encode_proof(forged))]


@attack("validity_lambda_swap", "cross-slot-claim-swap")
def _validity_lambda_swap(ctx: AttackContext) -> List[VariantResult]:
    """Re-prove with the two validity-statement lambdas exchanged: the
    main claim rides the remainder slice's weight and vice versa.  The
    prover is fully honest about everything else; the verifier's OWN
    lambda schedule must refuse the transposed weighting."""
    orig = openings_mod.merged_lambdas

    def swapped(cfg, rho):
        lam1, lam2 = orig(cfg, rho)
        return lam2, lam1

    with _patched(openings_mod, "merged_lambdas", swapped):
        raw = ctx.reprove(ctx.wits, 5)
    return [ctx.expect_reject("vmain/vrem lambda weights transposed", raw)]


@attack("bq_basis_splice", "cross-slot-claim-swap")
def _bq_basis_splice(ctx: AttackContext) -> List[VariantResult]:
    """Commit the bq slot under the zkReLU G-column basis (a sub-basis
    of the vmain slice) instead of its own fresh slice — the repeated-
    generator forgery the merged-key freshness invariant exists to
    block.  The prover is honest modulo the spliced key."""
    keys = ctx.pk.keys
    honest = keys.slot_keys["bq"]
    spliced = pedersen.CommitKey(keys.validity.g_col, honest.h,
                                 b"zkdl/audit/bq-splice")
    keys.slot_keys["bq"] = spliced
    try:
        raw = ctx.reprove(ctx.wits, 6)
    finally:
        keys.slot_keys["bq"] = honest
    return [ctx.expect_reject("bq slot committed under zkReLU g_col "
                              "basis", raw)]


@attack("bq_column_swap", "cross-slot-claim-swap")
def _bq_column_swap(ctx: AttackContext) -> List[VariantResult]:
    """Swap the bq slot commitment with the zkReLU column commitment
    com_bq1 — both commit (blinds aside) to the same B_{Q-1} bits, just
    under different bases, so a verifier that conflated the two slices
    would accept."""
    forged = decode_proof(ctx.proof_bytes)
    slots = dict(forged.coms.slots)
    slots["bq"], forged.coms.validity.com_bq1 = \
        forged.coms.validity.com_bq1, slots["bq"]
    forged.coms.slots = slots
    return [ctx.expect_reject("bq slot com <-> validity com_bq1",
                              encode_proof(forged))]


# -- replay and splicing ----------------------------------------------------

@attack("cross_vk_replay", "replay")
def _cross_vk_replay(ctx: AttackContext) -> List[VariantResult]:
    """Honest bytes presented to the WRONG verifier: a different model
    geometry, and the same geometry with a different step window."""
    qc = ctx.quant
    alt_widths = (ctx.widths[0] * 2,) + ctx.widths[1:]
    g2 = build_fcnn_graph(alt_widths, batch=ctx.batch)
    cfg2 = PipelineConfig.from_graph(g2, q_bits=qc.q_bits,
                                     r_bits=qc.r_bits, n_steps=ctx.n_steps)
    g3 = build_fcnn_graph(ctx.widths, batch=ctx.batch)
    cfg3 = PipelineConfig.from_graph(g3, q_bits=qc.q_bits,
                                     r_bits=qc.r_bits,
                                     n_steps=ctx.n_steps + 1)
    # each wrong key derives its tables on the context's device, and is
    # dropped as soon as its verify returns
    return [
        ctx.expect_reject(f"replayed under widths={alt_widths} vk",
                          ctx.proof_bytes,
                          vk=VerifyingKey(cfg=cfg2, device=ctx.device)),
        ctx.expect_reject(f"replayed under n_steps={ctx.n_steps + 1} vk",
                          ctx.proof_bytes,
                          vk=VerifyingKey(cfg=cfg3, device=ctx.device)),
    ]


@attack("cross_label_replay", "replay")
def _cross_label_replay(ctx: AttackContext) -> List[VariantResult]:
    """The transcript is domain-separated by deployment label: a proof
    minted for one domain must not verify in another."""
    return [ctx.expect_reject("replayed under label+'/replayed'",
                              ctx.proof_bytes,
                              label=ctx.label + b"/replayed")]


@attack("cross_window_replay", "replay")
def _cross_window_replay(ctx: AttackContext) -> List[VariantResult]:
    """Window-level replay against the membership audit: claim window 1
    trained on some samples, but present window 0's (honest, verifying)
    proof bytes.  `verify_bytes` alone accepts — the DatasetBinding's
    per-window commitment digest is what must refuse the swap."""
    from repro_torch.audit import membership as mem

    raw2 = ctx.second_window()
    tree, binding = mem.build_binding({0: mem.sample_coms(ctx.proof_bytes),
                                       1: mem.sample_coms(raw2)})
    queried = [mem.com_to_bytes(c) for c in mem.sample_coms(raw2)[:3]]
    audit = mem.prove_membership(tree, binding, 1, queried)
    verdict = mem.verify_membership(binding, audit,
                                    proof_bytes=ctx.proof_bytes)
    honest = mem.verify_membership(binding, audit, proof_bytes=raw2)
    return [
        VariantResult("window-1 claim with window-0 proof bytes",
                      rejected=not verdict.ok, trace=verdict.reason),
        VariantResult("control: honest window-1 bytes accepted",
                      rejected=honest.ok,
                      trace="" if honest.ok else honest.reason),
    ]


@attack("proof_splice", "proof-splice")
def _proof_splice(ctx: AttackContext) -> List[VariantResult]:
    """Graft sections between two honest proofs under the SAME vk and
    label — each donor section verifies in its own proof, so only the
    transcript binding across sections can reject the hybrid."""
    a = decode_proof(ctx.proof_bytes)
    b = decode_proof(ctx.second_window())
    out = [
        ctx.expect_reject("IPA section grafted from a second window",
                          encode_proof(dataclasses.replace(
                              a, ipa_agg=b.ipa_agg))),
        ctx.expect_reject("commitment section grafted from a second "
                          "window",
                          encode_proof(dataclasses.replace(a, coms=b.coms))),
    ]
    return out


# -- zkReLU validity-table forgeries ----------------------------------------

@attack("validity_negative_gap", "validity-forgery")
def _validity_negative_gap(ctx: AttackContext) -> List[VariantResult]:
    """Alias one gap entry by +2^Q: the committed tensor changes (2^Q is
    not 0 in the field) while the bit decomposition — wrapped back into
    signed range so the real prover can still run — stays that of the
    in-range value.  A verifier that only checked bit-recomposition
    modulo 2^Q would accept this out-of-range witness."""
    qc = ctx.quant
    wits = copy.deepcopy(ctx.wits)
    g0 = wits[0].gap
    arr = g0[0] if isinstance(g0, (list, tuple)) else g0
    arr.view(-1)[0] += 1 << qc.q_bits

    orig_bits = zkrelu.build_aux_bits

    def wrapping_bits(zpp, gap, bq, rz, rga, q_bits, r_bits):
        lim = 1 << (q_bits - 1)
        gap_in_range = torch.remainder(gap.to(torch.int64) + lim,
                                       1 << q_bits) - lim
        return orig_bits(zpp, gap_in_range, bq, rz, rga, q_bits, r_bits)

    with _patched(zkrelu, "build_aux_bits", wrapping_bits):
        raw = ctx.reprove(wits, 12)
    return [ctx.expect_reject("gap entry aliased by +2^Q, bits wrapped "
                              "into range", raw)]


@attack("validity_wrong_bit_planes", "validity-forgery")
def _validity_wrong_bit_planes(ctx: AttackContext) -> List[VariantResult]:
    """Flip one bit of the zkReLU bit matrix and keep the negated matrix
    consistent (B' = 1 - B with the forced-zero column) — commitments
    and product tables all agree with the forged planes; only the
    recomposition against the committed tensors can reject."""
    orig_bits = zkrelu.build_aux_bits

    def flipped_bits(zpp, gap, bq, rz, rga, q_bits, r_bits):
        bits = orig_bits(zpp, gap, bq, rz, rga, q_bits, r_bits)
        b = bits.b_mat.clone()
        b[0, 0] ^= 1
        bneg = 1 - b
        bneg[:zpp.shape[0], q_bits - 1] = 0
        return dataclasses.replace(bits, b_mat=b, bneg=bneg)

    with _patched(zkrelu, "build_aux_bits", flipped_bits):
        raw = ctx.reprove(ctx.wits, 13)
    return [ctx.expect_reject("b_mat[0,0] flipped, bneg kept consistent",
                              raw)]


# -- metadata tampering -----------------------------------------------------

@attack("forged_step_count", "meta-tamper")
def _forged_step_count(ctx: AttackContext) -> List[VariantResult]:
    forged = decode_proof(ctx.proof_bytes)
    return [ctx.expect_reject(
        "META n_steps incremented",
        encode_proof(dataclasses.replace(forged,
                                         n_steps=forged.n_steps + 1)))]
