"""Operations and bytes: the least work each kernel's call and each
aggregation window need, and the least time the chip could take for it.

Every count follows the kernel table's yardstick: each input read once
and each output written once, a 64-bit Montgomery product counted as 38
32-bit integer operations, an exact int16 product as four int8 digit
products.  The counts depend on the cell's geometry alone, so they stay
the same whatever implements the work.
"""
from __future__ import annotations

from typing import List, Tuple

from zkbench.work import peaks
from zkbench.work.geometry import Geometry

WORD = 8                               # bytes of one field or group word


def bound_s(n_bytes: float, n_int32_ops: float = 0.0,
            n_int8_ops: float = 0.0) -> float:
    """The least seconds the chip takes: the larger of the byte bound
    and the operation bound."""
    t_bytes = n_bytes / peaks.HBM_BYTES_PER_S
    t_ops = (n_int32_ops / peaks.INT32_OPS_PER_S
             + n_int8_ops / peaks.INT8_OPS_PER_S)
    return max(t_bytes, t_ops)


# -- the witness's exact products (the qmatmul kernel) ----------------------

def step_products(geo: Geometry) -> List[Tuple[int, int, int]]:
    """(M, K, N) of every exact integer product of one SGD step: the
    forward Z^l = A^{l-1} W^l, the backward G_A^{l-1} = G_Z^l W^{l,T}
    (l >= 2) and the weight gradient G_W^l = G_Z^{l,T} A^{l-1}."""
    B, d = geo.batch, geo.widths
    out = []
    for l in range(1, geo.n_layers + 1):
        out.append((B, d[l - 1], d[l]))                 # forward
        if l >= 2:
            out.append((B, d[l], d[l - 1]))             # backward
        out.append((d[l], B, d[l - 1]))                 # weight gradient
    return out


def qmatmul_bytes(m: int, k: int, n: int) -> int:
    """int16 operands in, the int64 product out."""
    return 2 * (m * k + k * n) + 8 * m * n


def qmatmul_int8_ops(m: int, k: int, n: int) -> int:
    """Four int8 digit products of 2MNK operations each."""
    return 4 * 2 * m * n * k


def qmatmul_step_bound_s(geo: Geometry) -> float:
    """The least time of one step's exact products, each call bounded on
    its own."""
    return sum(bound_s(qmatmul_bytes(*p), n_int8_ops=qmatmul_int8_ops(*p))
               for p in step_products(geo))


# -- the zkReLU validity tables ---------------------------------------------

def validity_positions(geo: Geometry) -> int:
    """(row, bit) positions of both eq. (19) statements of one proof."""
    return geo.validity_main + geo.validity_rem


def validity_tables_bound_s(geo: Geometry) -> float:
    """Six 4-byte planes and two field tables in, two field tables out
    (56 bytes) and one Montgomery product per position."""
    n = validity_positions(geo)
    return bound_s(56 * n, n_int32_ops=peaks.MONT_MUL_INT32_OPS * n)


# -- one aggregation window: T steps, one proof, its verification -----------

def committed_elements(geo: Geometry) -> int:
    """Elements of every committed vector with general (not 0/1)
    entries, unpadded: the data rows, the labels, W and G_W, and the
    Z'', R_Z, G_A' and R_GA decompositions.  A Pedersen commitment of n
    elements and its blind needs at least n group products."""
    T, B, d, L = geo.n_steps, geo.batch, geo.widths, geo.n_layers
    weights = sum(d[l - 1] * d[l] for l in range(1, L + 1))
    acts = sum(d[1:])
    grads = sum(d[1:L])
    return T * (B * d[0] + B * d[L] + 2 * weights
                + 2 * B * acts + 2 * B * grads)


def ipa_products(n: int) -> int:
    """Montgomery products of a pair IPA over n elements: each round of
    length m computes its L and R commitments (at least m products each),
    folds both witness vectors (m products each) and both generator
    vectors (at least m / 2 products each), until one element is left."""
    total = 0
    while n > 1:
        total += 5 * n
        n //= 2
    return total


def ipa_bytes(n: int) -> int:
    """Each round reads the two witness and two generator vectors of
    length m once and writes them at half length."""
    total = 0
    while n > 1:
        total += 4 * (n + n // 2) * WORD
        n //= 2
    return total


def window_work(geo: Geometry) -> dict:
    """The least work of one aggregation window: the T steps' exact
    products, the commitments, the merged pair IPA and the verifier's
    final multi-exponentiation over both merged bases."""
    n = geo.merged_len
    commits = committed_elements(geo)
    products = commits + ipa_products(n) + 2 * n
    n_bytes = (2 * WORD * commits + ipa_bytes(n) + 2 * WORD * n
               + geo.n_steps * sum(qmatmul_bytes(*p)
                                   for p in step_products(geo)))
    int8_ops = geo.n_steps * sum(qmatmul_int8_ops(*p)
                                 for p in step_products(geo))
    return {"montgomery_products": products, "int8_ops": int8_ops,
            "bytes": n_bytes}


def window_bound_s(geo: Geometry) -> float:
    w = window_work(geo)
    return bound_s(w["bytes"],
                   n_int32_ops=peaks.MONT_MUL_INT32_OPS
                   * w["montgomery_products"],
                   n_int8_ops=w["int8_ops"])
