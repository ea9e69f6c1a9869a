"""Zero-knowledge inner-product arguments (Bulletproofs style).

Two variants, both log-size and linear-prover-time:

* ``open_*`` proves <a, b_pub> = c for a *committed* vector a and a
  *public* vector b (the MLE-opening workhorse: b = e(u)).
* ``pair_*`` proves <a, b> = c where BOTH vectors are bound inside one
  commitment C = h^rho G^a H^b -- the statement Algorithm 1 produces for
  the zkReLU validity equation (19), and the shape of the pipeline's one
  merged opening.

Honest-verifier zero knowledge comes from per-round blinds on L/R plus
a final sigma opening.

Each pair prover round is one two-row MSM for L and R (per row the two
half-MSMs and the u^{c} claim term and h^{rho} blind as a two-term
tail, three segments read in place), one host transfer for the
transcript, and the folds:
the scalar halves through the `fold_halves` kernel, the generator
halves through the `pow_mul` kernel: in the pair rounds as one merge
g_lo * g_hi^{e} (its e_lo = 1 case) with the outer exponent deferred
into ``gam_g`` / ``gam_h`` (applied to the two surviving generators
before the sigma finale), in the open rounds as g_lo^{ali} * g_hi^{al}.
Every emitted group element equals the reference's (`repro.core.ipa`)
bit for bit.  The reference's "ladder" round schedule only bounds XLA
compiles and has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.field import FQ, decode, from_mont, mont_mul
from repro_torch.core import group
from repro_torch.core.mle import enc, fdot
from repro_torch.core.transcript import Transcript
# the IPA scalar fold c_lo * v[:n/2] + c_hi * v[n/2:] is the fold_halves
# kernel itself (reference: `_fold_halves`, ipa.py:199)
from repro_torch.kernels.sumcheck_fold import fold_halves as _fold_halves
# the IPA generator fold lo^{e_lo} * hi^{e_hi} (reference: the Pallas
# route of `_open_fold_dispatch`, ipa.py:224)
from repro_torch.kernels.sumcheck_fold import pow_mul_halves

Q = FQ.modulus


def _sub(prof, name: str):
    from repro_torch.core.pipeline.profile import subphase
    return subphase(prof, name)


@dataclasses.dataclass
class IpaProof:
    ls: List[int]
    rs: List[int]
    # final sigma-protocol messages
    sigma: List[int]

    def size_bytes(self) -> int:
        return 32 * (len(self.ls) + len(self.rs) + len(self.sigma))


def _dec_scalar(x: torch.Tensor) -> int:
    return int(decode(FQ, x.reshape(()))[()])


def _exp1(e: int) -> int:
    """One python-int exponent -> its standard form mod q."""
    return int(e) % Q


def _fold_vec(t: torch.Tensor, lo_coef: int, hi_coef: int) -> torch.Tensor:
    """lo_coef * t[:n/2] + hi_coef * t[n/2:] for python-int coefficients."""
    return _fold_halves(t, enc(lo_coef), enc(hi_coef))


def _u_gen(device) -> torch.Tensor:
    return group.derive_generators(b"zkdl/ipa-u", 1, device)[0]


def _rand(rng) -> int:
    return int(rng.integers(0, Q, dtype=np.uint64)) % Q


def _s_vector(n: int, alphas: List[int], low_exp_is_inv: bool,
              device) -> torch.Tensor:
    """s_i = prod_j (alpha_j or its inverse) by the top-bit split pattern."""
    rounds = len(alphas)
    s = torch.full((n,), FQ.one, dtype=torch.int64, device=device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    for j, a in enumerate(alphas):
        ai = pow(a, Q - 2, Q)
        lo, hi = (ai, a) if low_exp_is_inv else (a, ai)
        bit = (idx >> (rounds - 1 - j)) & 1
        coef = torch.where(bit == 0, enc(lo), enc(hi))
        s = mont_mul(FQ, s, coef)
    return s


def _lr_tail(up, h, c_l: torch.Tensor, c_r: torch.Tensor, rho_l: int,
             rho_r: int):
    """The up^{claim} * h^{rho} tails of L and R as one MSM segment: the
    shared points (up, h) and a (2, 2) block of exponents."""
    exps = torch.stack([
        torch.stack([c_l, torch.tensor(rho_l, device=up.device)]),
        torch.stack([c_r, torch.tensor(rho_r, device=up.device)])])
    return torch.stack([up, h]), exps


def _claims(a: torch.Tensor, b: torch.Tensor):
    n2 = a.shape[0] // 2
    return (from_mont(FQ, fdot(a[:n2], b[n2:])),
            from_mont(FQ, fdot(a[n2:], b[:n2])))


def _pair_round_lr(gg, hh, a, b, up, h_blind, rho_l: int, rho_r: int,
                   gam_g: int, gam_h: int) -> torch.Tensor:
    """L/R of one pair round; the stored bases carry deferred outer
    exponents (true bases gg^{gam_g} / hh^{gam_h}), which ride the MSM
    scalars: mont_mul(a, gam) with gam in standard form IS the standard
    form of a * gam."""
    n2 = a.shape[0] // 2
    c_l, c_r = _claims(a, b)
    a_std = mont_mul(FQ, a, gam_g)
    b_std = mont_mul(FQ, b, gam_h)
    return _lr_msms(gg, hh, a_std, b_std[n2:], b_std[:n2],
                    _lr_tail(up, h_blind, c_l, c_r, rho_l, rho_r))


def _lr_msms(gg, hh, ea, eb_l, eb_r, tail) -> torch.Tensor:
    """L = gg_hi^{ea_lo} hh_lo^{eb_l} tail_0 and
    R = gg_lo^{ea_hi} hh_hi^{eb_r} tail_1 as one two-row MSM of three
    segments that read the halves in place (eb_l and eb_r are the two
    halves of one vector, in either order)."""
    n2 = ea.shape[0] // 2
    return group.msm_segments([([gg[n2:], gg[:n2]], [ea[:n2], ea[n2:]]),
                               ([hh[:n2], hh[n2:]], [eb_l, eb_r]), tail])


def _pair_round_lr_w(gg, h_base, w, a, b, up, h_blind, rho_l: int,
                     rho_r: int) -> torch.Tensor:
    """First pair round with the H basis held as h_base^{w} (zkReLU's
    H' = H^{1/e}, never materialized): the weight rides the exponents,
    w_lo * b_hi and w_hi * b_lo as the halves of one vector."""
    n2 = a.shape[0] // 2
    c_l, c_r = _claims(a, b)
    a_std = from_mont(FQ, a)
    wb = from_mont(FQ, mont_mul(FQ, w, b.roll(n2)))
    return _lr_msms(gg, h_base, a_std, wb[:n2], wb[n2:],
                    _lr_tail(up, h_blind, c_l, c_r, rho_l, rho_r))


def _pair_fold_first(a, b, g_table, h_table, w, al: int, ali: int,
                     al2: int, ali2: int):
    """First pair fold over FIXED bases via precomputed squaring tables,
    with the H-side weight vector folded into the table exponents; the
    outer exponents are deferred as in `_pair_fold`."""
    n2 = a.shape[0] // 2
    a2 = _fold_halves(a, enc(al), enc(ali))
    b2 = _fold_halves(b, enc(ali), enc(al))
    al2_t = torch.tensor(al2, device=a.device)
    powed_g = group.g_pow_table(g_table[:, n2:], al2_t)
    gg2 = group.g_mul(g_table[0, :n2], powed_g)
    w_coef = torch.cat([torch.full((n2,), FQ.one, device=a.device),
                        torch.full((n2,), enc(ali2), device=a.device)])
    h_exps = from_mont(FQ, mont_mul(FQ, w, w_coef))
    powed_h = group.g_pow_table(h_table, h_exps)
    hh2 = group.g_mul(powed_h[:n2], powed_h[n2:])
    return a2, b2, gg2, hh2


def _pair_fold(a, b, gg, hh, al: int, ali: int, al2: int, ali2: int):
    """Pair fold with the OUTER generator exponent deferred: the true
    folded bases are (gg_lo * gg_hi^{al^2})^{ali} and
    (hh_lo * hh_hi^{ali^2})^{al}; only the inner merges are materialized
    and ali / al accumulate into gam_g / gam_h."""
    n2 = a.shape[0] // 2
    a2 = _fold_halves(a, enc(al), enc(ali))
    b2 = _fold_halves(b, enc(ali), enc(al))
    gg2 = pow_mul_halves(gg, 1, _exp1(al2))
    hh2 = pow_mul_halves(hh, 1, _exp1(ali2))
    return a2, b2, gg2, hh2


# ---------------------------------------------------------------------------
# Variant 1: committed a, public b.
# ---------------------------------------------------------------------------

def _open_round_lr(gens, a, b, up, h, rho_l: int, rho_r: int
                   ) -> torch.Tensor:
    """L/R of one `open` round:

    L = gens_hi^{a_lo} * up^{<a_lo, b_hi>} * h^{rho_l}
    R = gens_lo^{a_hi} * up^{<a_hi, b_lo>} * h^{rho_r}
    """
    n2 = a.shape[0] // 2
    c_l, c_r = _claims(a, b)
    a_std = from_mont(FQ, a)
    main = torch.stack([group.msm(gens[n2:], a_std[:n2]),
                        group.msm(gens[:n2], a_std[n2:])])
    tail = group.msm_many(*_lr_tail(up, h, c_l, c_r, rho_l, rho_r))
    return group.g_mul(main, tail)


def _open_fold(a, b, gens, al: int, ali: int):
    """a' = al*a_lo + ali*a_hi, b' = ali*b_lo + al*b_hi and
    gens' = gens_lo^{ali} * gens_hi^{al}: two `fold_halves` launches and
    one `pow_mul` launch (the reference's Pallas route, ipa.py:231-234)."""
    a2 = _fold_halves(a, enc(al), enc(ali))
    b2 = _fold_halves(b, enc(ali), enc(al))
    return a2, b2, pow_mul_halves(gens, _exp1(ali), _exp1(al))


def open_prove(key, a_mont: torch.Tensor, b_mont: torch.Tensor, blind: int,
               claim: int, transcript: Transcript, rng: np.random.Generator,
               prof=None) -> IpaProof:
    """Prove <a, b> = claim for a committed in ``key`` with ``blind``
    (com = h^blind gens^a) and b public; both in Montgomery form."""
    n = a_mont.shape[0]
    assert n & (n - 1) == 0 and b_mont.shape[0] == n
    dev = a_mont.device
    gens = key.gens[:n]
    transcript.absorb_int(b"ipa/claim", claim)
    x = transcript.challenge_int(b"ipa/x", Q)
    up = group.g_pow_int(_u_gen(dev), x)

    a, b, rho = a_mont, b_mont, int(blind)
    ls, rs = [], []
    with _sub(prof, "ipa-rounds"):
        while n > 1:
            rho_l, rho_r = _rand(rng), _rand(rng)
            li, ri = group.decode_group_many(
                _open_round_lr(gens, a, b, up, key.h, rho_l, rho_r))
            ls.append(li)
            rs.append(ri)
            transcript.absorb_ints(b"ipa/lr", [li, ri])
            al = transcript.challenge_int(b"ipa/alpha", Q)
            ali = pow(al, Q - 2, Q)
            a, b, gens = _open_fold(a, b, gens, al, ali)
            rho = (al * al % Q * rho_l + rho + ali * ali % Q * rho_r) % Q
            n //= 2

    with _sub(prof, "sigma"):
        # final Schnorr opening of P_f = base^a h^rho, base = g_f up^{b_f}
        a_f, b_f = (int(v) for v in decode(FQ, torch.stack([a[0], b[0]])))
        s, s_rho = _rand(rng), _rand(rng)
        # K = base^s h^{s_rho} = gens_f^s up^{s b_f} h^{s_rho}
        ki = group.decode_group(group.msm(
            torch.stack([gens[0], up, key.h]),
            group.exps_from_ints([s, s * b_f % Q, s_rho], dev)))
        transcript.absorb_int(b"ipa/K", ki)
        e = transcript.challenge_int(b"ipa/e", Q)
        z = (s + e * a_f) % Q
        z_rho = (s_rho + e * rho) % Q
    return IpaProof(ls, rs, [ki, z, z_rho])


def open_verify(key, com: torch.Tensor, b_mont: torch.Tensor, claim: int,
                proof: IpaProof, transcript: Transcript) -> bool:
    """Verify an `open_prove` proof of <a, b> = claim against com."""
    n = b_mont.shape[0]
    assert n & (n - 1) == 0
    if len(proof.ls) != n.bit_length() - 1 or \
            len(proof.rs) != len(proof.ls) or len(proof.sigma) != 3:
        return False
    dev = b_mont.device
    gens = key.gens[:n]
    transcript.absorb_int(b"ipa/claim", claim)
    x = transcript.challenge_int(b"ipa/x", Q)
    up = group.g_pow_int(_u_gen(dev), x)
    p = group.g_mul(com, group.g_pow_int(up, claim))

    b = b_mont
    alphas = []
    for li, ri in zip(proof.ls, proof.rs):
        transcript.absorb_ints(b"ipa/lr", [li, ri])
        al = transcript.challenge_int(b"ipa/alpha", Q)
        ali = pow(al, Q - 2, Q)
        alphas.append(al)
        b = _fold_vec(b, ali, al)
        p = group.g_mul(p, group.msm(
            torch.stack([group.encode_group(li, dev),
                         group.encode_group(ri, dev)]),
            group.exps_from_ints([al * al % Q, ali * ali % Q], dev)))

    s = _s_vector(n, alphas, low_exp_is_inv=True, device=dev)
    g_f = group.msm_field(gens, s)
    base = group.g_mul(g_f, group.g_pow_int(up, _dec_scalar(b[0])))
    ki, z, z_rho = proof.sigma
    transcript.absorb_int(b"ipa/K", ki)
    e = transcript.challenge_int(b"ipa/e", Q)
    lhs = group.g_mul(group.g_pow_int(base, z), group.g_pow_int(key.h, z_rho))
    rhs = group.g_mul(group.encode_group(ki, dev), group.g_pow_int(p, e))
    return group.decode_group(lhs) == group.decode_group(rhs)


def pair_prove_many(stmts, transcript: Transcript,
                    rng: np.random.Generator,
                    prof=None) -> List[IpaProof]:
    """Prove S pair statements with interleaved rounds.

    ``stmts`` is a list of ``(g_gens, h_gens, h_blind, a_mont, b_mont,
    blind, claim)``, optionally extended with an 8th element
    ``accel = (g_table, h_base, h_table, w_mont)`` declaring FIXED bases
    with precomputed squaring tables and the true H basis h_base^{w}.
    Transcript order per round: each active statement's (L, R) is
    absorbed and its alpha drawn, statement by statement."""
    states = []
    for stmt in stmts:
        gg, hh, hb, a, b, blind, claim = stmt[:7]
        accel = stmt[7] if len(stmt) > 7 else None
        n = a.shape[0]
        assert n & (n - 1) == 0 and b.shape[0] == n
        assert accel is None or n > 1, "accel statement needs n >= 2"
        transcript.absorb_int(b"ipa2/claim", claim)
        x = transcript.challenge_int(b"ipa2/x", Q)
        states.append({"n": n, "gg": gg[:n],
                       "hh": hh[:n] if hh is not None else None,
                       "hb": hb, "a": a, "b": b, "rho": int(blind),
                       "up": group.g_pow_int(_u_gen(a.device), x),
                       "accel": accel, "ls": [], "rs": [],
                       "gam_g": 1, "gam_h": 1})

    with _sub(prof, "ipa-rounds"):
        while any(st["n"] > 1 for st in states):
            active = [st for st in states if st["n"] > 1]
            lrs, blind_draws = [], []
            for st in active:
                rho_l, rho_r = _rand(rng), _rand(rng)
                blind_draws.append((rho_l, rho_r))
                if st["accel"] is not None:
                    _, h_base, _, w = st["accel"]
                    lrs.append(_pair_round_lr_w(st["gg"], h_base, w, st["a"],
                                                st["b"], st["up"], st["hb"],
                                                rho_l, rho_r))
                else:
                    lrs.append(_pair_round_lr(st["gg"], st["hh"], st["a"],
                                              st["b"], st["up"], st["hb"],
                                              rho_l, rho_r, st["gam_g"],
                                              st["gam_h"]))
            flat = group.decode_group_many(torch.cat(lrs))   # 1 transfer
            for k, (st, (rho_l, rho_r)) in enumerate(zip(active,
                                                         blind_draws)):
                li, ri = flat[2 * k], flat[2 * k + 1]
                st["ls"].append(li)
                st["rs"].append(ri)
                transcript.absorb_ints(b"ipa2/lr", [li, ri])
                al = transcript.challenge_int(b"ipa2/alpha", Q)
                ali = pow(al, Q - 2, Q)
                al2, ali2 = al * al % Q, ali * ali % Q
                if st["accel"] is not None:
                    g_table, _, h_table, w = st["accel"]
                    st["a"], st["b"], st["gg"], st["hh"] = _pair_fold_first(
                        st["a"], st["b"], g_table, h_table, w, al, ali, al2,
                        ali2)
                    st["accel"] = None
                else:
                    st["a"], st["b"], st["gg"], st["hh"] = _pair_fold(
                        st["a"], st["b"], st["gg"], st["hh"], al, ali, al2,
                        ali2)
                st["gam_g"] = st["gam_g"] * ali % Q
                st["gam_h"] = st["gam_h"] * al % Q
                st["rho"] = (al2 * rho_l + st["rho"] + ali2 * rho_r) % Q
                st["n"] //= 2

    with _sub(prof, "sigma"):
        dev = states[0]["a"].device
        # apply the deferred outer exponents to the two surviving
        # generators of every statement in one batched g_pow
        gam_fin = group.g_pow(
            torch.stack([st[k][0] for st in states for k in ("gg", "hh")]),
            group.exps_from_ints([st[g] for st in states
                                  for g in ("gam_g", "gam_h")], dev))
        finals = decode(FQ, torch.stack([st[k][0] for st in states
                                         for k in ("a", "b")]))
        one = group.identity(dev)
        pts, exps, sigmas = [], [], []
        for i, st in enumerate(states):
            g_f, h_f = gam_fin[2 * i], gam_fin[2 * i + 1]
            a_f, b_f = int(finals[2 * i]), int(finals[2 * i + 1])
            s_a, s_b, s_rho, t_rho = (_rand(rng), _rand(rng), _rand(rng),
                                      _rand(rng))
            # A = g_f^{s_a} h_f^{s_b} up^{a_f s_b + b_f s_a} h^{s_rho}
            # B = up^{s_a s_b} h^{t_rho}
            pts.append(torch.stack([g_f, h_f, st["up"], st["hb"]]))
            pts.append(torch.stack([st["up"], st["hb"], one, one]))
            exps.append(group.exps_from_ints(
                [s_a, s_b, (a_f * s_b + b_f * s_a) % Q, s_rho], dev))
            exps.append(group.exps_from_ints([s_a * s_b % Q, t_rho, 0, 0],
                                             dev))
            sigmas.append((a_f, b_f, s_a, s_b, s_rho, t_rho))
        ab_flat = group.decode_group_many(
            group.msm_many(torch.stack(pts), torch.stack(exps)))

        proofs = []
        for i, st in enumerate(states):
            a_f, b_f, s_a, s_b, s_rho, t_rho = sigmas[i]
            ai, bi = ab_flat[2 * i], ab_flat[2 * i + 1]
            transcript.absorb_ints(b"ipa2/AB", [ai, bi])
            e = transcript.challenge_int(b"ipa2/e", Q)
            z_a = (a_f * e + s_a) % Q
            z_b = (b_f * e + s_b) % Q
            z_rho = (st["rho"] * e % Q * e + s_rho * e + t_rho) % Q
            proofs.append(IpaProof(st["ls"], st["rs"],
                                   [ai, bi, z_a, z_b, z_rho]))
        return proofs


def pair_verify_many(stmts, proofs: List[IpaProof],
                     transcript: Transcript) -> bool:
    """Verify S pair statements proven by `pair_prove_many`.

    ``stmts`` is a list of ``(g_gens, h_gens, h_blind, com, claim, n)``;
    replays the interleaved transcript schedule and checks every sigma
    equation (all group comparisons decode in one transfer)."""
    states = []
    for (gg, hh, hb, com, claim, n), proof in zip(stmts, proofs):
        assert n & (n - 1) == 0
        dev = gg.device
        transcript.absorb_int(b"ipa2/claim", claim)
        x = transcript.challenge_int(b"ipa2/x", Q)
        up = group.g_pow_int(_u_gen(dev), x)
        if len(proof.ls) != n.bit_length() - 1 or \
                len(proof.rs) != len(proof.ls):
            return False
        states.append({"n": n, "n0": n, "gg": gg, "hh": hh, "hb": hb,
                       "up": up, "proof": proof, "round": 0, "alphas": [],
                       "p": group.g_mul(com, group.g_pow_int(up, claim))})

    while any(st["n"] > 1 for st in states):
        for st in states:
            if st["n"] <= 1:
                continue
            dev = st["gg"].device
            li = st["proof"].ls[st["round"]]
            ri = st["proof"].rs[st["round"]]
            transcript.absorb_ints(b"ipa2/lr", [li, ri])
            al = transcript.challenge_int(b"ipa2/alpha", Q)
            ali = pow(al, Q - 2, Q)
            st["alphas"].append(al)
            st["p"] = group.g_mul(st["p"], group.msm(
                torch.stack([group.encode_group(li, dev),
                             group.encode_group(ri, dev)]),
                group.exps_from_ints([al * al % Q, ali * ali % Q], dev)))
            st["round"] += 1
            st["n"] //= 2

    sides = []
    for st in states:
        n = st["n0"]
        dev = st["gg"].device
        s = _s_vector(n, st["alphas"], low_exp_is_inv=True, device=dev)
        s_inv = _s_vector(n, st["alphas"], low_exp_is_inv=False, device=dev)
        g_f = group.msm_field(st["gg"][:n], s)
        h_f = group.msm_field(st["hh"][:n], s_inv)
        if len(st["proof"].sigma) != 5:
            return False
        ai, bi, z_a, z_b, z_rho = st["proof"].sigma
        transcript.absorb_ints(b"ipa2/AB", [ai, bi])
        e = transcript.challenge_int(b"ipa2/e", Q)
        lhs = group.g_mul(
            group.g_mul(group.g_pow_int(st["p"], e * e % Q),
                        group.g_pow_int(group.encode_group(ai, dev), e)),
            group.encode_group(bi, dev))
        rhs = group.g_mul(
            group.g_mul(group.g_pow_int(g_f, z_a * e % Q),
                        group.g_pow_int(h_f, z_b * e % Q)),
            group.g_mul(group.g_pow_int(st["up"], z_a * z_b % Q),
                        group.g_pow_int(st["hb"], z_rho)))
        sides.extend([lhs, rhs])
    flat = group.decode_group_many(torch.stack(sides))
    return all(flat[2 * i] == flat[2 * i + 1] for i in range(len(states)))


def pair_prove(g_gens, h_gens, h_blind, a_mont, b_mont, blind: int,
               claim: int, transcript: Transcript,
               rng: np.random.Generator) -> IpaProof:
    """Single-statement pair argument: `pair_prove_many` with S = 1,
    which degenerates to the classic sequential schedule."""
    (proof,) = pair_prove_many(
        [(g_gens, h_gens, h_blind, a_mont, b_mont, blind, claim)],
        transcript, rng)
    return proof


def pair_verify(g_gens, h_gens, h_blind, com, claim: int, proof: IpaProof,
                transcript: Transcript, n: int) -> bool:
    return pair_verify_many([(g_gens, h_gens, h_blind, com, claim, n)],
                            [proof], transcript)
