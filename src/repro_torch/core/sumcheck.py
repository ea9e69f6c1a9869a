"""Generic sum-of-products sumcheck prover/verifier over FQ.

Proves claims of the form

    claim = sum_{b in {0,1}^d}  sum_p  coef_p * prod_{k in products[p]} T_k(b)

for a list of distinct MLE tables ``T_k`` and products given as index
tuples -- the one primitive behind every zkDL sumcheck (matmul layers,
the anchor relation (27)).  The prover keeps the K tables as one (K, n)
stack: per round one evaluation pass, one host transfer for the
Fiat-Shamir absorb, and one `sumcheck_fold` kernel launch that halves
every table.  The reference folds into a fixed-shape buffer with a zero
tail only to bound XLA compiles; the values are identical, so the port
folds with the shrinking form.  The verifier is host python ints.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.field import FQ, add, decode, fsum, mont_mul, sub
from repro_torch.core.mle import enc, enc_vec, hadd, hmul, lagrange_eval
from repro_torch.core.transcript import Transcript
from repro_torch.kernels.sumcheck_fold import fold as _kernel_fold

Q = FQ.modulus


@dataclasses.dataclass
class SumcheckProof:
    # messages[r] = list of degree+1 ints: round poly evals at X=0..degree
    messages: List[List[int]]


def _round_msgs(stack: torch.Tensor, idx: torch.Tensor, coefs: torch.Tensor,
                degree: int) -> torch.Tensor:
    """All degree+1 round-poly evaluations of a (K, n) table stack:
    returns (degree+1,) Montgomery sums.

    ``idx`` is the (P, degree) product-index matrix, ragged products
    padded with index K -- a synthetic Montgomery-ONE table appended to
    the eval stack (multiplying by the Montgomery unit is the identity,
    so padded factors change nothing)."""
    evens = stack[:, 0::2]
    odds = stack[:, 1::2]
    diffs = sub(FQ, odds, evens)
    one_row = torch.full((1, evens.shape[1]), FQ.one, dtype=torch.int64,
                         device=stack.device)
    evens = torch.cat([evens, one_row])
    odds = torch.cat([odds, one_row])
    diffs = torch.cat([diffs, torch.zeros_like(one_row)])
    evals = [evens, odds]
    cur = odds
    for _ in range(2, degree + 1):
        cur = add(FQ, cur, diffs)
        evals.append(cur)
    msgs = []
    for ev in evals:
        term = ev[idx[:, 0]]
        for k in range(1, degree):
            term = mont_mul(FQ, term, ev[idx[:, k]])
        # per-product sums first, then the public coefficients: the
        # same field value as scaling every column, with P multiplies
        msgs.append(fsum(FQ, mont_mul(FQ, fsum(FQ, term), coefs)))
    return torch.stack(msgs)


def _fold_stack(stack: torch.Tensor, r_m: int) -> torch.Tensor:
    """Fix variable 0 of every table of the (K, n) stack: one launch."""
    k, n = stack.shape
    return _kernel_fold(stack, r_m).reshape(k, n // 2)


def sumcheck_prove(
    tables: List[torch.Tensor] | torch.Tensor,
    products: Sequence[Tuple[int, ...]],
    transcript: Transcript,
    label: bytes,
    coefs: Sequence[int] | None = None,
) -> Tuple[SumcheckProof, List[int], List[int]]:
    """Returns (proof, point, final_values) where final_values[k] = T_k(point).

    ``tables`` is a list of K (n,) tables or their (K, n) stack, which
    is then used as it is (no copy).  ``coefs`` (optional) gives one
    public field coefficient per product:
    claim = sum_b sum_p coefs[p] * prod_k T_k(b)."""
    n = tables[0].shape[0]
    assert all(t.shape[0] == n for t in tables)
    device = tables[0].device
    degree = max(len(p) for p in products)
    rounds = n.bit_length() - 1
    assert n == 1 << rounds
    if coefs is not None:
        coef_t = enc_vec([int(c) % Q for c in coefs], device)
    else:
        coef_t = torch.full((len(products),), FQ.one, dtype=torch.int64,
                            device=device)
    k_one = len(tables)            # index of the synthetic ONE pad table
    idx = torch.tensor(np.array(
        [list(p) + [k_one] * (degree - len(p)) for p in products],
        dtype=np.int64), device=device)

    stack = tables if isinstance(tables, torch.Tensor) else \
        torch.stack(tables)
    messages: List[List[int]] = []
    point: List[int] = []
    for _ in range(rounds):
        msg = [int(v) for v in decode(FQ, _round_msgs(stack, idx, coef_t,
                                                      degree))]
        messages.append(msg)
        transcript.absorb_ints(label + b"/round", msg)
        r = transcript.challenge_int(label + b"/r", Q)
        point.append(r)
        stack = _fold_stack(stack, enc(r))
    final_values = [int(v) for v in decode(FQ, stack[:, 0])]
    transcript.absorb_ints(label + b"/final", final_values)
    return SumcheckProof(messages), point, final_values


def sumcheck_verify(
    claim: int,
    proof: SumcheckProof,
    degree: int,
    rounds: int,
    transcript: Transcript,
    label: bytes,
) -> Tuple[List[int], int]:
    """Checks round consistency; returns (point, expected final combination).

    The caller must separately check that
        expected == sum_p prod_k final_values[k]
    using final values that are themselves bound to commitments.
    Raises ValueError on an inconsistent transcript.
    """
    if len(proof.messages) != rounds:
        raise ValueError("sumcheck: wrong number of rounds")
    running = claim % Q
    point: List[int] = []
    for msg in proof.messages:
        if len(msg) != degree + 1:
            raise ValueError("sumcheck: wrong round-poly degree")
        if hadd(msg[0], msg[1]) != running:
            raise ValueError("sumcheck: round consistency check failed")
        transcript.absorb_ints(label + b"/round", msg)
        r = transcript.challenge_int(label + b"/r", Q)
        point.append(r)
        running = lagrange_eval(msg, r)
    return point, running


def combine_final(products: Sequence[Tuple[int, ...]], final_values: List[int],
                  coefs: Sequence[int] | None = None) -> int:
    acc = 0
    for pi, prod in enumerate(products):
        term = 1
        for k in prod:
            term = hmul(term, final_values[k])
        if coefs is not None:
            term = hmul(term, int(coefs[pi]) % Q)
        acc = hadd(acc, term)
    return acc
