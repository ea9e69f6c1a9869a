"""The Pedersen commitment group and multi-scalar multiplication.

The group is the order-q subgroup of quadratic residues of F_p^*, with
p = 2q + 1.  A group element is one FP word in Montgomery form; the
group operation is ``mont_mul(FP, ., .)`` (the modmul kernel on the
card) and exponents are standard-form FQ words.

MSM on a CUDA tensor is the msm kernel (`repro_torch.kernels.msm`): one
launch (two for rows longer than a block's tile) of a joint
square-and-multiply over every row.  On a CPU tensor it is the plain
version, a sort-based Pippenger in torch ops (`msm_many_plain`,
`msm_ragged_plain`): per window, the (row, digit) bucket keys of all
terms are sorted (`torch.sort`), the points gathered in that order, and
the per-bucket products formed by a log-depth segmented tree of modmul
launches (`_segment_products`); rows of at most 32 terms multiply out
`g_pow` instead.  The group is commutative and every product is exact,
so any algorithm, bucket or term order gives the reference's values bit
for bit; padding the reference applies to bound its compiled shapes is
left out.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.field import (FP, FQ, GROUP_GEN, decode, from_mont, mont_mul,
                               pow_const)
from repro_torch.kernels import msm as _kernel_msm
from repro_torch.kernels.generators import derive as _kernel_derive
from repro_torch.kernels.powmod import powmod as _kernel_powmod

P = FP.modulus
Q = FQ.modulus

#: rows of at most this many terms multiply out g_pow + tree products
#: instead of running Pippenger (fewer launches; same values)
NAIVE_MAX_TERMS = 32
#: rows of at least this many terms run one at a time, so the sort's
#: keys, indices and gathered points exist for one row only
BIG_ROW_TERMS = 1 << 22


def identity(device) -> torch.Tensor:
    return torch.tensor(FP.one, dtype=torch.int64, device=device)


def g_mul(a, b) -> torch.Tensor:
    """Group operation."""
    return mont_mul(FP, a, b)


def g_inv(a: torch.Tensor) -> torch.Tensor:
    """Group inverse (p is prime, so a^{p-2})."""
    return pow_const(FP, a, P - 2)


def g_pow_int(base: torch.Tensor, e: int) -> torch.Tensor:
    """base^e for a python-int exponent (e taken mod q)."""
    return pow_const(FP, base, int(e) % Q)


def g_pow(bases: torch.Tensor, exps_std: torch.Tensor,
          nbits: int = 61) -> torch.Tensor:
    """Elementwise bases^exps, exponents in standard form (broadcasting),
    over their low ``nbits`` bits: the powmod kernel on the card, its
    torch-op square-and-multiply on the CPU."""
    return _kernel_powmod(FP, bases, exps_std, nbits)


def pow_table(bases: torch.Tensor, nbits: int = 61) -> torch.Tensor:
    """Squaring chains: (n,) bases -> (nbits, n) with table[j] = bases^{2^j}."""
    rows = [bases]
    for _ in range(nbits - 1):
        rows.append(g_mul(rows[-1], rows[-1]))
    return torch.stack(rows)


def g_pow_table(table: torch.Tensor, exps_std: torch.Tensor,
                nbits: int = 61) -> torch.Tensor:
    """Elementwise bases^exps via a `pow_table`: one conditional multiply
    per bit, bit-identical to `g_pow` on the same bases."""
    exps = exps_std.expand(table.shape[1:])
    res = torch.full(table.shape[1:], FP.one, dtype=torch.int64,
                     device=table.device)
    for j in range(nbits):
        bit = ((exps >> j) & 1) != 0
        res = torch.where(bit, g_mul(res, table[j]), res)
    return res


def tree_prod(elems: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Product of all group elements along ``dim`` (pairwise halving)."""
    x = elems.movedim(dim, 0).contiguous()
    while x.shape[0] > 1:
        if x.shape[0] % 2 == 1:
            x = torch.cat([x, torch.full_like(x[:1], FP.one)])
        h = x.shape[0] // 2
        x = g_mul(x[:h], x[h:])
    if x.shape[0] == 0:
        return torch.full(x.shape[1:], FP.one, dtype=torch.int64,
                          device=x.device)
    return x[0]


def msm_bits(points: torch.Tensor, bits) -> torch.Tensor:
    """prod points[i]^{bits[i]} for a 0/1 vector: pure selection product."""
    bits = torch.as_tensor(bits, device=points.device).reshape(-1) != 0
    n = bits.shape[0]
    sel = torch.where(bits, points[:n], identity(points.device))
    return tree_prod(sel)


def _segment_products(keys: torch.Tensor, vals: torch.Tensor,
                      out: torch.Tensor, dump: int) -> None:
    """Write into ``out[key]`` the product of every run of equal keys in
    the sorted (keys, vals); ``out[dump]`` is scratch.

    A log-depth merge of aligned blocks: a block keeps its head run
    (first key, product) and tail run (last key, product) and a flag for
    "one key only".  Merging blocks A|B multiplies A's tail by B's head
    (one modmul launch per level over half the blocks) and writes out
    the runs that the merge closes; every run closes exactly once, so
    the scatters never collide on a real key."""
    n = keys.numel()
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        keys = torch.cat([keys, keys.new_full((m - n,), dump)])
        vals = torch.cat([vals, vals.new_full((m - n,), FP.one)])
    hk = tk = keys
    hv = tv = vals
    single = torch.ones(m, dtype=torch.bool, device=keys.device)
    while hk.numel() > 1:
        a_hk, b_hk = hk[0::2], hk[1::2]
        a_hv, b_hv = hv[0::2], hv[1::2]
        a_tk, b_tk = tk[0::2], tk[1::2]
        a_tv, b_tv = tv[0::2], tv[1::2]
        a_s, b_s = single[0::2], single[1::2]
        joined = g_mul(a_tv, b_hv)
        eq = a_tk == b_hk
        # A's tail run closes unless it continues into B's head and that
        # head is also B's tail (then it becomes the merged tail)
        # runs that do not close are sent to the scratch slot: a masked
        # scatter needs no host sync, where compacting the closed runs
        # first (nonzero) would stall the launch queue at every level
        emit_a = ~a_s & (~eq | ~b_s)
        out[torch.where(emit_a, a_tk, dump).long()] = torch.where(
            eq, joined, a_tv)
        emit_b = ~eq & ~b_s
        out[torch.where(emit_b, b_hk, dump).long()] = b_hv
        hv = torch.where(a_s & eq, joined, a_hv)
        tv = torch.where(b_s & eq, joined, b_tv)
        hk, tk = a_hk, b_tk
        single = a_s & b_s & eq
    out[hk.long()] = hv
    out[torch.where(single, dump, tk).long()] = tv


def _window_for(n_row: int) -> int:
    """Digit width for rows of n_row terms: about log2(n) - 4, in [2, 16]
    (each window costs one sort of every term plus 2^w buckets per row)."""
    return min(16, max(2, n_row.bit_length() - 4))


def _pippenger(points: torch.Tensor, exps: torch.Tensor, rows: torch.Tensor,
               n_rows: int, nbits: int, window: int,
               shared_points: bool) -> torch.Tensor:
    """Row-batched Pippenger: ``exps`` (any shape), ``rows`` (the row id
    of every term, broadcastable to exps); ``points`` matches exps, or
    with ``shared_points`` is one (n,) vector indexed by the last exps
    axis.  Returns (n_rows,) products."""
    dev = exps.device
    nb = 1 << window
    nwin = -(-nbits // window)
    n_keys = n_rows * nb
    n_last = exps.shape[-1]
    flat_pts = points.reshape(-1)
    # 32-bit keys sort in half the radix passes of 64-bit ones
    key_type = torch.int32 if n_keys < (1 << 31) else torch.int64
    row_key = rows * nb
    buckets = torch.full((nwin, n_keys + 1), FP.one, dtype=torch.int64,
                         device=dev)
    for w in range(nwin):
        key = (row_key + ((exps >> (window * w)) & (nb - 1))).reshape(-1)
        skey, order = torch.sort(key.to(key_type))
        del key
        vals = flat_pts[order % n_last] if shared_points else flat_pts[order]
        del order
        _segment_products(skey, vals, buckets[w], n_keys)
        del skey, vals
    b = buckets[:, :n_keys].reshape(nwin, n_rows, nb)
    j = torch.arange(nb, dtype=torch.int64, device=dev)
    win = tree_prod(g_pow(b, j, nbits=window), dim=-1)     # (nwin, n_rows)
    total = win[nwin - 1]
    for w in range(nwin - 2, -1, -1):
        for _ in range(window):
            total = g_mul(total, total)
        total = g_mul(total, win[w])
    return total


def msm_many(points: torch.Tensor, exps_std: torch.Tensor, nbits: int = 61,
             window: int | None = None) -> torch.Tensor:
    """R independent MSMs: (R, n) exponents (standard form) against (R, n)
    points, or one (n,) point vector shared by every row -> (R,).

    On the card the msm kernel, which ignores ``window``; on the CPU
    `msm_many_plain`."""
    if exps_std.device.type != "cpu":
        return _kernel_msm.msm([(points, exps_std)], nbits)
    return msm_many_plain(points, exps_std, nbits, window)


def msm_many_plain(points: torch.Tensor, exps_std: torch.Tensor,
                   nbits: int = 61, window: int | None = None
                   ) -> torch.Tensor:
    """`msm_many` in torch ops, on any device: rows of at most
    NAIVE_MAX_TERMS terms by `g_pow`, longer ones by `_pippenger` with
    digits of ``window`` bits (default: `_window_for` the row length)."""
    assert exps_std.dim() == 2
    r, n = exps_std.shape
    assert points.shape in ((n,), (r, n)), (points.shape, exps_std.shape)
    dev = exps_std.device
    if n == 0:
        return torch.full((r,), FP.one, dtype=torch.int64, device=dev)
    if window is None and n <= NAIVE_MAX_TERMS:
        return tree_prod(g_pow(points, exps_std, nbits=nbits), dim=1)
    if r > 1 and n >= BIG_ROW_TERMS:
        return torch.stack([
            msm_many_plain(points if points.dim() == 1 else points[i],
                           exps_std[i][None], nbits=nbits, window=window)[0]
            for i in range(r)])
    w = window if window is not None else _window_for(n)
    rows = torch.arange(r, dtype=torch.int64, device=dev)[:, None]
    return _pippenger(points, exps_std, rows, r, nbits, w,
                      shared_points=points.dim() == 1)


def msm(points: torch.Tensor, exps_std: torch.Tensor, nbits: int = 61,
        window: int | None = None) -> torch.Tensor:
    """prod_i points[i]^exps[i]; exps as (n,) standard-form words."""
    n = points.shape[0]
    assert n == exps_std.shape[0]
    return msm_many(points, exps_std[None], nbits=nbits, window=window)[0]


def msm_segments(segments, nbits: int = 61) -> torch.Tensor:
    """R MSMs whose rows are up to three (points, exps) segments laid end
    to end, read in place (`repro_torch.kernels.msm.msm` says what a
    segment may be) -> (R,), each row equal to its concatenated row's
    MSM.  On the CPU the rows are concatenated for `msm_many_plain`."""
    return _kernel_msm.msm(segments, nbits)


def msm_ragged(points: torch.Tensor, exps_std: torch.Tensor,
               rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """MSMs of rows of different lengths, flattened: term i belongs to row
    rows[i] -> (n_rows,) products (no padding terms).  On the card the
    msm kernel, with each row's terms together (``rows`` non-decreasing);
    on the CPU `msm_ragged_plain`."""
    if exps_std.device.type != "cpu":
        return _kernel_msm.msm_ragged(points, exps_std, rows, n_rows)
    return msm_ragged_plain(points, exps_std, rows, n_rows)


def msm_ragged_plain(points: torch.Tensor, exps_std: torch.Tensor,
                     rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """`msm_ragged` by `_pippenger`, on any device."""
    w = _window_for(max(1, exps_std.numel() // n_rows))
    return _pippenger(points, exps_std, rows, n_rows, 61, w,
                      shared_points=False)


def msm_field(points: torch.Tensor, scalars_mont: torch.Tensor,
              nbits: int = 61) -> torch.Tensor:
    """MSM where scalars are FQ elements in Montgomery form."""
    return msm(points, from_mont(FQ, scalars_mont), nbits)


# ---------------------------------------------------------------------------
# Generators (nothing-up-my-sleeve, unknown discrete logs).
# ---------------------------------------------------------------------------

_GEN_CACHE: dict = {}
# held across the check, the derivation and the insert: two prover
# threads asking for one label derive it once
_GEN_LOCK = threading.Lock()


def derive_generators(label: bytes, n: int, device) -> torch.Tensor:
    """n independent subgroup generators; hash-to-group (t -> t^2 mod p).

    On the card this is the generator kernel, one thread per index.  A
    generator depends only on (label, index), so the per-label cache
    extends instead of re-deriving."""
    device = torch.device(device)
    key = (label, str(device))
    with _GEN_LOCK:
        cached = _GEN_CACHE.get(key)
        have = 0 if cached is None else cached.shape[0]
        if have >= n:
            return cached[:n]
        new = _kernel_derive(label, have, n - have, device)
        out = new if cached is None else torch.cat([cached, new])
        _GEN_CACHE[key] = out
        return out


def group_gen(device) -> torch.Tensor:
    """The canonical subgroup generator h = 4 in Montgomery form."""
    return encode_group(GROUP_GEN, device)


def decode_group(a: torch.Tensor) -> int:
    """Group element -> canonical python int (for transcripts/serialization)."""
    return int(decode(FP, a.reshape(()))[()])


def decode_group_many(a: torch.Tensor) -> list:
    """(R,) group elements -> list of R python ints, ONE host transfer."""
    return [int(v) for v in decode(FP, a.reshape(-1))]


def encode_group(x: int, device) -> torch.Tensor:
    gm = (int(x) % P) * pow(2, 64, P) % P
    return torch.tensor(gm, dtype=torch.int64, device=device)


def exps_from_ints(vals, device) -> torch.Tensor:
    """Python ints (mod q) -> standard-form exponent words."""
    arr = np.array([int(v) % Q for v in vals], dtype=np.int64)
    return torch.as_tensor(arr, device=device)
