"""SC-BD baseline: bit-decomposition range proofs via the GENERAL-PURPOSE
sumcheck backend (the comparison column of Table 2 / Figure 1).

This is the approach zkDL is measured against: each auxiliary tensor's
range requirement is proven by handing the bit-decomposition relation to a
general-purpose circuit sumcheck, eq. (36):

    aux~(u) = sum_{i,j,k} beta~(u,i) . add~(i,(j,k)) . B~(j,k) . s_k

where ``add~`` is the circuit wiring predicate connecting output element i
to its Q bit-gates.  A general-purpose backend materializes the predicate
over the full (i,(j,k)) index space, so the prover runs over THREE tables
of size D^2 Q -- the Omega(D^2 Q) proving time of Table 1 -- versus
zkReLU's O(DQ).  A separate degree-3 sumcheck proves binarity
(B .* (B-1) = 0).

The three wiring tables are built on the proof's device as one (3, D^2 Q)
stack (at D = 2^12, Q = 16 each is 2^28 words, 2 GiB) and driven through
the same `sumcheck_prove` as every zkDL sumcheck, so the comparison
isolates the PROTOCOL difference, not the arithmetic substrate.  The
transcript domains and the proof encoding are the reference's
(`repro.core.scbd`); the verifier is host python ints.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.field import FQ, decode, encode_i64, sub
from repro_torch.core import mle
from repro_torch.core.mle import enc_vec, expand_point, fdot
from repro_torch.core.sumcheck import (SumcheckProof, combine_final,
                                       sumcheck_prove, sumcheck_verify)
from repro_torch.core.transcript import Transcript
from repro_torch.core.zkrelu import bits_signed

Q_MOD = FQ.modulus


def _log2(n: int) -> int:
    assert n & (n - 1) == 0
    return n.bit_length() - 1


@dataclasses.dataclass
class ScbdProof:
    claim: int
    sc_main: SumcheckProof
    main_finals: List[int]
    sc_bin: SumcheckProof
    bin_finals: List[int]

    def size_bytes(self) -> int:
        n = 2  # claim + binary claim
        for sc in (self.sc_main, self.sc_bin):
            n += sum(len(m) for m in sc.messages)
        n += len(self.main_finals) + len(self.bin_finals)
        return 32 * n

    def proof_ints(self) -> List[int]:
        """Canonical flat integer encoding (length-prefixed sections) —
        the basis of the golden digest pin that guards the transcript
        domains against silent drift."""
        out = [self.claim]
        for sc in (self.sc_main, self.sc_bin):
            out.append(len(sc.messages))
            for msg in sc.messages:
                out.append(len(msg))
                out.extend(int(v) for v in msg)
        for finals in (self.main_finals, self.bin_finals):
            out.append(len(finals))
            out.extend(int(v) for v in finals)
        return out

    def digest(self) -> str:
        h = hashlib.sha256()
        for v in self.proof_ints():
            h.update(int(v).to_bytes(32, "little"))
        return h.hexdigest()


def _s_weights(q_bits: int) -> List[int]:
    s = [pow(2, k, Q_MOD) for k in range(q_bits - 1)]
    s.append((-pow(2, q_bits - 1, Q_MOD)) % Q_MOD)
    return s


def _wiring_stack(e_u: torch.Tensor, bs_t: torch.Tensor) -> torch.Tensor:
    """The (3, D * D * Q) stack of the main sumcheck's tables over the
    index (i, j, k), i high and k low:

        T1[i,(j,k)] = e_u[i]           (broadcast over j, k)
        T2[i,(j,k)] = eq(i, j)         (the wiring predicate, 0/1)
        T3[i,(j,k)] = B[j,k] * s_k     (broadcast over i)
    """
    d, inner = e_u.shape[0], bs_t.shape[0]
    stack = torch.zeros((3, d * inner), dtype=torch.int64,
                        device=e_u.device)
    stack[0].view(d, inner).copy_(e_u[:, None].expand(d, inner))
    ar = torch.arange(d, device=e_u.device)
    stack[1].view(d, d, inner // d)[ar, ar] = FQ.one
    stack[2].view(d, inner).copy_(bs_t[None, :].expand(d, inner))
    return stack


def prove(aux, q_bits: int, transcript: Transcript,
          device=None) -> ScbdProof:
    """Prove aux (int64, signed q_bits-bit, length D = power of 2) is in
    range, the general-purpose way: materialize the D^2 Q wiring tables.

    ``aux`` is a numpy array or a tensor; the tables live on ``device``
    (default: the card, or the device of a tensor ``aux``)."""
    if device is None and isinstance(aux, torch.Tensor):
        device = aux.device
    dev = resolve_device(device)
    aux = torch.as_tensor(np.asarray(aux) if not isinstance(
        aux, torch.Tensor) else aux, device=dev).to(torch.int64).reshape(-1)
    d = aux.shape[0]
    ld, lq = _log2(d), _log2(q_bits)
    bits = bits_signed(aux, q_bits)               # (D, Q) in {0,1}
    t = transcript

    # --- main recomposition sumcheck over (i, j, k): index i high, k low ---
    u = t.challenge_ints(b"scbd/u", Q_MOD, ld)
    e_u = expand_point(u, dev)                                # (D,)
    claim = int(decode(FQ, fdot(e_u, encode_i64(FQ, aux)))[()])
    t.absorb_ints(b"scbd/claim", [claim])

    s_t = enc_vec(_s_weights(q_bits), dev)
    bs_t = torch.where(bits.bool(), s_t[None, :], 0).reshape(-1)
    sc_main, _, main_finals = sumcheck_prove(
        _wiring_stack(e_u, bs_t), [(0, 1, 2)], t, b"scbd/main")

    # --- binarity sumcheck over (j, k): B .* (B - 1) = 0 -------------------
    u2 = t.challenge_ints(b"scbd/u2", Q_MOD, ld + lq)
    e2 = expand_point(u2, dev)                                # (D*Q,)
    b_t = torch.where(bits.reshape(-1).bool(), FQ.one, 0)
    b_minus1 = sub(FQ, b_t, torch.full_like(b_t, FQ.one))
    sc_bin, _, bin_finals = sumcheck_prove([e2, b_t, b_minus1], [(0, 1, 2)],
                                           t, b"scbd/bin")
    return ScbdProof(claim, sc_main, main_finals, sc_bin, bin_finals)


def verify(proof: ScbdProof, d: int, q_bits: int,
           transcript: Transcript) -> bool:
    ld, lq = _log2(d), _log2(q_bits)
    t = transcript
    u = t.challenge_ints(b"scbd/u", Q_MOD, ld)
    t.absorb_ints(b"scbd/claim", [proof.claim])
    try:
        w, expected = sumcheck_verify(proof.claim, proof.sc_main, 3,
                                      2 * ld + lq, t, b"scbd/main")
        if expected != combine_final([(0, 1, 2)], proof.main_finals):
            return False
        t.absorb_ints(b"scbd/main/final", proof.main_finals)
        # recompute the public tables' finals: T1 = e_u (vars: k,j low; i high)
        w_k, w_j, w_i = w[:lq], w[lq:lq + ld], w[lq + ld:]
        t1_chk = mle.heval_point_product(u, w_i)
        if proof.main_finals[0] != t1_chk:
            return False
        t2_chk = mle.heval_point_product(w_i, w_j)
        if proof.main_finals[1] != t2_chk:
            return False
        # T3 final is an opening claim on the committed bits -- bound by the
        # bit commitment in a full deployment; accepted as a claim here.
        u2 = t.challenge_ints(b"scbd/u2", Q_MOD, ld + lq)
        w2, expected2 = sumcheck_verify(0, proof.sc_bin, 3, ld + lq,
                                        t, b"scbd/bin")
        if expected2 != combine_final([(0, 1, 2)], proof.bin_finals):
            return False
        t.absorb_ints(b"scbd/bin/final", proof.bin_finals)
        if proof.bin_finals[0] != mle.heval_point_product(u2, w2):
            return False
        if proof.bin_finals[2] != (proof.bin_finals[1] - 1) % Q_MOD:
            return False
        return True
    except ValueError:
        return False


def mle_host_expand(point: List[int]) -> List[int]:
    return mle.hexpand_point(point)


def workload_elems(d: int, q_bits: int) -> int:
    """Table elements the general-purpose prover materializes (per tensor)."""
    return d * d * q_bits
