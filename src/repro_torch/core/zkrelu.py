"""zkReLU: batched validity proofs for the auxiliary inputs (Section 4.1).

The prover commits to the bit matrices

    B  = [[bits(Z'') | 0], [signed-bits(G_A')]]   in {0,1}^{2Ds x Q}
    B' = B - 1 (except the forced-zero column, which stays 0)

via com_B^ip = h^r G^B H^{B'} (Protocol 1) and proves the combined
inner-product relation (19) through the commitment transformation of
Algorithm 1 and the two-sided IPA; the remainders R_Z / R_GA use the
same machinery with an unsigned R-bit s-vector.  The eq. (19) a/b
tables of both statements come out of ONE `validity_tables` kernel
launch over the raw stacked integers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch

from repro_torch.field import FQ, FP, batch_inv, from_mont, mont_mul
from repro_torch.core import group, ipa
from repro_torch.core.mle import enc, enc_vec, expand_point, hexpand_point
from repro_torch.core.transcript import Transcript
from repro_torch.kernels import validity_tables as vtab

Q_MOD = FQ.modulus
P_MOD = FP.modulus


def _rand_scalar(rng) -> int:
    return int(rng.integers(0, Q_MOD, dtype=np.uint64)) % Q_MOD


def bits_unsigned(v: torch.Tensor, nbits: int) -> torch.Tensor:
    """(n,) int64 in [0, 2^nbits) -> (n, nbits) 0/1 int8."""
    assert bool(((v >= 0) & (v < (1 << nbits))).all())
    sh = torch.arange(nbits, dtype=torch.int64, device=v.device)
    return ((v[:, None] >> sh[None, :]) & 1).to(torch.int8)


def bits_signed(v: torch.Tensor, nbits: int) -> torch.Tensor:
    """(n,) int64 in [-2^{nbits-1}, 2^{nbits-1}) -> (n, nbits) two's compl."""
    lim = 1 << (nbits - 1)
    assert bool(((v >= -lim) & (v < lim)).all())
    u = torch.where(v < 0, v + (1 << nbits), v)
    sh = torch.arange(nbits, dtype=torch.int64, device=v.device)
    return ((u[:, None] >> sh[None, :]) & 1).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class ValidityKeys:
    """Generator bases. The B_{Q-1} sub-basis is the column Q-1 of the
    Z''-half of G, so a commitment to B_{Q-1} under g IS a commitment
    to \\bar{B}_{Q-1} under G."""
    g_big: torch.Tensor     # (2 Ds Q,)
    h_big: torch.Tensor     # (2 Ds Q,)
    g_r: torch.Tensor       # (2 Ds R,)  remainder bases
    h_r: torch.Tensor       # (2 Ds R,)
    h_blind: torch.Tensor   # ()
    ds: int
    q_bits: int
    r_bits: int

    @property
    def device(self) -> torch.device:
        return self.g_big.device

    def _col_idx(self) -> torch.Tensor:
        return (torch.arange(self.ds, device=self.device) * self.q_bits
                + (self.q_bits - 1))

    @property
    def g_col(self) -> torch.Tensor:
        """g = G[0:Ds, Q-1]: basis for standalone B_{Q-1} commitments."""
        return self.g_big[self._col_idx()]

    @property
    def h_col(self) -> torch.Tensor:
        return self.h_big[self._col_idx()]

    @property
    def n_main(self) -> int:
        return 2 * self.ds * self.q_bits

    @property
    def n_rem(self) -> int:
        return 2 * self.ds * self.r_bits

    @property
    def merged_len(self) -> int:
        """Power-of-two length of the lam-merged (main ++ rem) statement."""
        n, m = self.n_main + self.n_rem, 1
        while m < n:
            m <<= 1
        return m

    def _tag(self) -> bytes:
        return b"ds%d-q%d-r%d" % (self.ds, self.q_bits, self.r_bits)

    @functools.cached_property
    def g_merged(self) -> torch.Tensor:
        """G basis of the merged statement: G ++ G_R ++ fresh pad."""
        pad = self.merged_len - self.n_main - self.n_rem
        parts = [self.g_big, self.g_r]
        if pad:
            parts.append(group.derive_generators(
                b"zkrelu/Gpad/" + self._tag(), pad, self.device))
        return torch.cat(parts)

    @functools.cached_property
    def h_merged(self) -> torch.Tensor:
        pad = self.merged_len - self.n_main - self.n_rem
        parts = [self.h_big, self.h_r]
        if pad:
            parts.append(group.derive_generators(
                b"zkrelu/Hpad/" + self._tag(), pad, self.device))
        return torch.cat(parts)

    @functools.cached_property
    def g_merged_table(self) -> torch.Tensor:
        return group.pow_table(self.g_merged)

    @functools.cached_property
    def h_merged_table(self) -> torch.Tensor:
        return group.pow_table(self.h_merged)


# first-round squaring tables above this basis length would pin 61x the
# basis in memory; past it the explicit (bit-identical) H' path runs
POW_TABLE_MAX_ELEMS = 1 << 16


def make_validity_keys(ds: int, q_bits: int, r_bits: int,
                       device) -> ValidityKeys:
    # Q and R must be powers of two so the bit index is a clean MLE
    # variable block (the paper pads tensors to powers of two likewise)
    assert q_bits & (q_bits - 1) == 0, "q_bits must be a power of two"
    assert r_bits & (r_bits - 1) == 0, "r_bits must be a power of two"
    assert ds & (ds - 1) == 0, "stacked aux length must be a power of two"
    tag = b"ds%d-q%d-r%d" % (ds, q_bits, r_bits)
    gen = functools.partial(group.derive_generators, device=device)
    return ValidityKeys(
        g_big=gen(b"zkrelu/G/" + tag, 2 * ds * q_bits),
        h_big=gen(b"zkrelu/H/" + tag, 2 * ds * q_bits),
        g_r=gen(b"zkrelu/GR/" + tag, 2 * ds * r_bits),
        h_r=gen(b"zkrelu/HR/" + tag, 2 * ds * r_bits),
        h_blind=gen(b"zkrelu/hb/" + tag, 1)[0],
        ds=ds, q_bits=q_bits, r_bits=r_bits)


def _commit_pm_bits(gens, plus_bits, minus_bits, h_blind, blind: int):
    """h^blind * gens^{plus} * gens^{-minus} for 0/1 matrices (flattened)."""
    acc = group.msm_bits(gens, plus_bits.reshape(-1))
    if minus_bits is not None:
        m = group.msm_bits(gens, minus_bits.reshape(-1))
        acc = group.g_mul(acc, group.g_inv(m))
    if blind:
        acc = group.g_mul(acc, group.g_pow_int(h_blind, blind))
    return acc


@dataclasses.dataclass
class AuxBits:
    """Bit matrices of the stacked aux tensors (int8 tensors), plus the
    raw stacked integers they decompose -- the validity-table kernel
    consumes the raw values and never reads the matrices."""
    b_mat: torch.Tensor       # (2Ds, Q) bits of (Z'' ; G_A')
    bneg: torch.Tensor        # (2Ds, Q) -B' = 1 - B, forced-zero column 0
    bq: torch.Tensor          # (Ds,) B_{Q-1}
    br_mat: torch.Tensor      # (2Ds, R) bits of (R_Z ; R_GA)
    brneg: torch.Tensor       # (2Ds, R) 1 - B_R
    zpp: torch.Tensor         # (Ds,) int64 Z''
    gap: torch.Tensor         # (Ds,) int64 G_A'
    rz: torch.Tensor          # (Ds,) int64 R_Z
    rga: torch.Tensor         # (Ds,) int64 R_GA


def build_aux_bits(zpp, gap, bq, rz, rga, q_bits: int,
                   r_bits: int) -> AuxBits:
    ds = zpp.shape[0]
    i8 = dict(dtype=torch.int8, device=zpp.device)
    b_mat = torch.zeros((2 * ds, q_bits), **i8)
    b_mat[:ds, : q_bits - 1] = bits_unsigned(zpp, q_bits - 1)
    b_mat[ds:, :] = bits_signed(gap, q_bits)
    bneg = 1 - b_mat                        # -B' = 1 - B
    bneg[:ds, q_bits - 1] = 0               # forced-zero column: B' = 0 there
    br_mat = torch.zeros((2 * ds, r_bits), **i8)
    br_mat[:ds] = bits_unsigned(rz, r_bits)
    br_mat[ds:] = bits_unsigned(rga, r_bits)
    return AuxBits(b_mat=b_mat, bneg=bneg, bq=bq.to(torch.int8),
                   br_mat=br_mat, brneg=1 - br_mat,
                   zpp=zpp.to(torch.int64), gap=gap.to(torch.int64),
                   rz=rz.to(torch.int64), rga=rga.to(torch.int64))


@dataclasses.dataclass
class ValidityCommitments:
    com_b_ip: int          # h^r G^B H^{B'}
    com_bq1: int           # h^{rq1} g_col^{B_{Q-1}}
    com_bq1p: int          # h^{r'} h_col^{B'_{Q-1}}
    com_br_ip: int         # h^{rr} GR^{B_R} HR^{B'_R}


@dataclasses.dataclass
class ValidityBlinds:
    r: int
    rq1: int
    rq1p: int
    rr: int


def commit_validity(keys: ValidityKeys, bits: AuxBits, rng) -> tuple:
    """Protocol 1 (trainer side): commitments to the bit matrices, with
    com_bq1 (B_{Q-1} under the g_col sub-basis, own blind) published in
    the same bundle."""
    r = _rand_scalar(rng)
    rq1 = _rand_scalar(rng)
    rq1p = _rand_scalar(rng)
    rr = _rand_scalar(rng)
    com_b = _commit_pm_bits(keys.g_big, bits.b_mat, None, keys.h_blind, 0)
    com_bp = _commit_pm_bits(keys.h_big, torch.zeros_like(bits.bneg),
                             bits.bneg, keys.h_blind, 0)
    com_b_ip = group.g_mul(group.g_mul(com_b, com_bp),
                           group.g_pow_int(keys.h_blind, r))
    # com of B_{Q-1} over g_col, com of B'_{Q-1} = B_{Q-1} - 1 over h_col
    com_bq1 = _commit_pm_bits(keys.g_col, bits.bq.reshape(-1, 1), None,
                              keys.h_blind, rq1)
    bq1p_neg = (1 - bits.bq).to(torch.int8)     # -(B_{Q-1}-1)
    com_bq1p = _commit_pm_bits(
        keys.h_col, torch.zeros((keys.ds, 1), dtype=torch.int8,
                                device=keys.device),
        bq1p_neg.reshape(-1, 1), keys.h_blind, rq1p)
    com_br = _commit_pm_bits(keys.g_r, bits.br_mat, None, keys.h_blind, 0)
    com_brp = _commit_pm_bits(keys.h_r, torch.zeros_like(bits.brneg),
                              bits.brneg, keys.h_blind, 0)
    com_br_ip = group.g_mul(group.g_mul(com_br, com_brp),
                            group.g_pow_int(keys.h_blind, rr))
    coms = ValidityCommitments(*group.decode_group_many(
        torch.stack([com_b_ip, com_bq1, com_bq1p, com_br_ip])))
    return coms, ValidityBlinds(r=r, rq1=rq1, rq1p=rq1p, rr=rr)


def _s_q_vector(q_bits: int) -> List[int]:
    """s_Q = (1, 2, ..., 2^{Q-2}, -2^{Q-1}) mod q."""
    s = [pow(2, j, Q_MOD) for j in range(q_bits - 1)]
    s.append(Q_MOD - pow(2, q_bits - 1, Q_MOD))
    return s


def _main_claim(v_k: int, vp_k: int, z: int, s_sum: int = -1) -> int:
    """RHS of (19): -z^3 sum(s) - (1 - v_k) z^2 + z v'_k."""
    return (-pow(z, 3, Q_MOD) * s_sum - (1 - v_k) * z * z + z * vp_k) % Q_MOD


@dataclasses.dataclass
class ValidityStatements:
    """Both eq. (19) pair-IPA statements, ready to be folded into a
    single direct-sum opening.  a/b are (n,) Montgomery witness tables;
    w is the H-basis exponent weight vector 1/e (Montgomery)."""
    a_main: torch.Tensor
    b_main: torch.Tensor
    w_main: torch.Tensor
    claim_main: int
    blind_main: int
    a_rem: torch.Tensor
    b_rem: torch.Tensor
    w_rem: torch.Tensor
    claim_rem: int
    blind_rem: int


def _kron(lo_point_e: torch.Tensor, e_relu: torch.Tensor) -> torch.Tensor:
    """e_relu (x) e_bit, bit index fastest: (rows * bits,)."""
    return mont_mul(FQ, e_relu[:, None], lo_point_e[None, :]).reshape(-1)


def prove_statements(keys: ValidityKeys, bits: AuxBits,
                     blinds: ValidityBlinds, u_relu: List[int], v: int,
                     v_q1: int, v_r: int,
                     transcript: Transcript) -> ValidityStatements:
    """Draw the validity challenges and build both statement witnesses
    (one `validity_tables` launch for both a/b pairs)."""
    ds, qb, rb = keys.ds, keys.q_bits, keys.r_bits
    dev = keys.device
    k = transcript.challenge_int(b"zkrelu/k", Q_MOD)
    u_bit = transcript.challenge_ints(b"zkrelu/ubit", Q_MOD,
                                      (qb - 1).bit_length())
    z = transcript.challenge_int(b"zkrelu/z", Q_MOD)
    u_bit_r = transcript.challenge_ints(b"zkrelu/ubitr", Q_MOD,
                                        (rb - 1).bit_length())
    z_r = transcript.challenge_int(b"zkrelu/zr", Q_MOD)

    e_relu = expand_point(u_relu, dev)
    assert e_relu.shape[0] == 2 * ds
    e_bit = expand_point(u_bit, dev)[:qb]
    e_bit_r = expand_point(u_bit_r, dev)[:rb]

    e_full_m = _kron(e_bit, e_relu)
    e_full_r = _kron(e_bit_r, e_relu)
    es_m = mont_mul(FQ, _kron(enc_vec(_s_q_vector(qb), dev), e_relu),
                    enc(z * z % Q_MOD))
    s_r = [pow(2, j, Q_MOD) for j in range(rb)]
    es_r = mont_mul(FQ, _kron(enc_vec(s_r, dev), e_relu),
                    enc(z_r * z_r % Q_MOD))

    layout = vtab.build_layout(bits.zpp, bits.gap, bits.bq, bits.rz,
                               bits.rga, qb, rb)
    a, b = vtab.build_tables(layout, k, z, z_r,
                             torch.cat([e_full_m, e_full_r]),
                             torch.cat([es_m, es_r]))
    n_main = layout.n_main

    # derived claim values (the verifier recomputes these itself)
    upp = u_relu[-1]
    v_k = (v - k * pow(2, qb - 1, Q_MOD) % Q_MOD
           * ((1 - upp) % Q_MOD) % Q_MOD * v_q1) % Q_MOD
    vp_k = _vp_k(k, u_relu, u_bit, qb)
    return ValidityStatements(
        a_main=a[:n_main], b_main=b[:n_main],
        w_main=batch_inv(FQ, e_full_m),
        claim_main=_main_claim(v_k, vp_k, z),
        blind_main=(blinds.r + k * (blinds.rq1 + blinds.rq1p)) % Q_MOD,
        a_rem=a[n_main:], b_rem=b[n_main:],
        w_rem=batch_inv(FQ, e_full_r),
        claim_rem=_main_claim(v_r, 1, z_r, s_sum=(1 << rb) - 1),
        blind_rem=blinds.rr)


@dataclasses.dataclass
class ValidityVerifyCtx:
    """Verifier-side mirror of `ValidityStatements`: the transformed
    commitments (Algorithm 1), recomputed claims and materialized
    H' = H^{1/e} bases."""
    com_t: torch.Tensor
    com_tr: torch.Tensor
    claim_main: int
    claim_rem: int
    h_prime_main: torch.Tensor
    h_prime_rem: torch.Tensor


def verify_statements(keys: ValidityKeys, coms: ValidityCommitments,
                      v: int, v_q1: int, v_r: int, u_relu: List[int],
                      transcript: Transcript) -> ValidityVerifyCtx:
    """Redraw the validity challenges and transform the commitments."""
    qb, rb = keys.q_bits, keys.r_bits
    dev = keys.device
    k = transcript.challenge_int(b"zkrelu/k", Q_MOD)
    u_bit = transcript.challenge_ints(b"zkrelu/ubit", Q_MOD,
                                      (qb - 1).bit_length())
    z = transcript.challenge_int(b"zkrelu/z", Q_MOD)
    u_bit_r = transcript.challenge_ints(b"zkrelu/ubitr", Q_MOD,
                                        (rb - 1).bit_length())
    z_r = transcript.challenge_int(b"zkrelu/zr", Q_MOD)

    upp = u_relu[-1]
    v_k = (v - k * pow(2, qb - 1, Q_MOD) % Q_MOD
           * ((1 - upp) % Q_MOD) % Q_MOD * v_q1) % Q_MOD
    vp_k = _vp_k(k, u_relu, u_bit, qb)

    # com_{B_{Q-1}}^ip = com_{B_{Q-1}} * com_{B'_{Q-1}}   (Protocol 1 line 3)
    com_bq1_ip = group.decode_group(
        group.g_mul(group.encode_group(coms.com_bq1, dev),
                    group.encode_group(coms.com_bq1p, dev)))
    com_t = transform_commitment(keys, coms.com_b_ip, com_bq1_ip, k, z, u_bit)
    com_tr = transform_commitment(keys, coms.com_br_ip, None, None, z_r,
                                  u_bit_r, remainder=True)
    e_relu = expand_point(u_relu, dev)
    return ValidityVerifyCtx(
        com_t=com_t, com_tr=com_tr,
        claim_main=_main_claim(v_k, vp_k, z),
        claim_rem=_main_claim(v_r, 1, z_r, s_sum=(1 << rb) - 1),
        h_prime_main=_h_prime_basis(keys.h_big, e_relu,
                                    expand_point(u_bit, dev)[:qb]),
        h_prime_rem=_h_prime_basis(keys.h_r, e_relu,
                                   expand_point(u_bit_r, dev)[:rb]))


def _vp_k(k: int, u_relu: List[int], u_bit: List[int], qb: int) -> int:
    """v'_k = 1 + (k-1) beta(bin(Q-1), u_bit) (1 - u'')   (eq. 15)."""
    upp = u_relu[-1]
    e_bit = hexpand_point(u_bit)
    beta = e_bit[qb - 1]
    return (1 + (k - 1) * beta % Q_MOD * ((1 - upp) % Q_MOD)) % Q_MOD


def _h_weights(e_relu: torch.Tensor, e_bit: torch.Tensor) -> torch.Tensor:
    """1/e for e = e_relu (x) e_bit -- the H-basis weights (Montgomery)."""
    return batch_inv(FQ, _kron(e_bit, e_relu))


def _h_prime_basis(h_big, e_relu, e_bit) -> torch.Tensor:
    """H'_i = H_i^{1/e_i}, e = e_relu (x) e_bit (Algorithm 1 basis).
    Verifier side only: the prover keeps the weights in exponent form."""
    return group.g_pow(h_big, from_mont(FQ, _h_weights(e_relu, e_bit)))


def transform_commitment(keys: ValidityKeys, com_b_ip: int, com_bq1_ip: int,
                         k: int, z: int, u_bit: List[int],
                         remainder: bool = False) -> torch.Tensor:
    """Algorithm 1: transform com into a commitment of (B_k - z1, b) under
    the bases (G, H^{e^{o-1}}).  Returns the group element."""
    qb = keys.r_bits if remainder else keys.q_bits
    g_big = keys.g_r if remainder else keys.g_big
    h_big = keys.h_r if remainder else keys.h_big
    dev = keys.device
    com = group.encode_group(com_b_ip, dev)
    if not remainder and k is not None:
        com = group.g_mul(com, group.g_pow_int(
            group.encode_group(com_bq1_ip, dev), k))
    # g^prod ^ {-z}
    gprod = group.tree_prod(g_big)
    com = group.g_mul(com, group.g_pow_int(gprod, (-z) % Q_MOD))
    # (h^prod_j)^{z^2 s_j / e_bit_j} column products
    e_bit = hexpand_point(u_bit)[:qb]
    s_vals = ([pow(2, j, Q_MOD) for j in range(qb)] if remainder
              else _s_q_vector(qb))
    colprods = group.tree_prod(h_big.reshape(2 * keys.ds, qb), dim=0)
    for j in range(qb):
        expo = (z * z % Q_MOD * s_vals[j] % Q_MOD
                * pow(e_bit[j], Q_MOD - 2, Q_MOD)) % Q_MOD
        expo = (expo + z) % Q_MOD            # + (h^prod)^z folded per column
        com = group.g_mul(com, group.g_pow_int(colprods[j], expo))
    return com


def prove_validity(keys: ValidityKeys, bits: AuxBits,
                   blinds: ValidityBlinds, u_relu: List[int], v: int,
                   v_q1: int, v_r: int, transcript: Transcript,
                   rng) -> "ipa.IpaProof":
    """Standalone validity of aux inputs: ONE merged pair IPA.

    The main and remainder statements become disjoint slices of the
    merged basis (G ++ G_R ++ pad); the remainder slice is lam-scaled so
    claim monomials stay distinct (claim = c_main + lam^2 c_rem) and the
    verifier can assemble the merged commitment as com_t * com_tr^lam.
    The pipeline does the same fold with rho-powers inside its
    direct-sum opening; this is the two-statement special case."""
    st = prove_statements(keys, bits, blinds, u_relu, v, v_q1, v_r,
                          transcript)
    lam = transcript.challenge_int(b"zkrelu/lam", Q_MOD)
    lam_m = enc(lam)
    pad = keys.merged_len - keys.n_main - keys.n_rem
    zeros = torch.zeros(pad, dtype=torch.int64, device=keys.device)
    a = torch.cat([st.a_main, mont_mul(FQ, st.a_rem, lam_m), zeros])
    b = torch.cat([st.b_main, mont_mul(FQ, st.b_rem, lam_m), zeros])
    w = torch.cat([st.w_main, st.w_rem, torch.full_like(zeros, enc(1))])
    claim = (st.claim_main + lam * lam % Q_MOD * st.claim_rem) % Q_MOD
    blind = (st.blind_main + lam * st.blind_rem) % Q_MOD
    if keys.merged_len <= POW_TABLE_MAX_ELEMS:
        stmt = (keys.g_merged, None, keys.h_blind, a, b, blind, claim,
                (keys.g_merged_table, keys.h_merged, keys.h_merged_table, w))
    else:
        hh = group.g_pow(keys.h_merged, from_mont(FQ, w))
        stmt = (keys.g_merged, hh, keys.h_blind, a, b, blind, claim)
    (proof,) = ipa.pair_prove_many([stmt], transcript, rng)
    return proof


def verify_validity(keys: ValidityKeys, coms: ValidityCommitments,
                    v: int, v_q1: int, v_r: int, u_relu: List[int],
                    proof: "ipa.IpaProof", transcript: Transcript) -> bool:
    """Standalone verifier for the merged validity IPA."""
    ctx = verify_statements(keys, coms, v, v_q1, v_r, u_relu, transcript)
    lam = transcript.challenge_int(b"zkrelu/lam", Q_MOD)
    com = group.g_mul(ctx.com_t, group.g_pow_int(ctx.com_tr, lam))
    claim = (ctx.claim_main + lam * lam % Q_MOD * ctx.claim_rem) % Q_MOD
    hh = torch.cat([ctx.h_prime_main, ctx.h_prime_rem,
                    keys.h_merged[keys.n_main + keys.n_rem:]])
    return ipa.pair_verify_many(
        [(keys.g_merged, hh, keys.h_blind, com, claim, keys.merged_len)],
        [proof], transcript)
