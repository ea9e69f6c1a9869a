"""Pedersen vector commitments (Section 3.1 of zkDL).

Commit(v; r) = h^r * prod_i g_i^{v_i} over the order-q subgroup of F_p^*.
Homomorphic: com(v1;r1) * com(v2;r2) = com(v1+v2; r1+r2), and
com(v;r)^k = com(k*v; k*r).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.field import FQ, from_mont
from repro_torch.core import group

Q = FQ.modulus


@dataclasses.dataclass(frozen=True)
class CommitKey:
    gens: torch.Tensor       # (n,) group elements (Montgomery form)
    h: torch.Tensor          # () blinding generator
    label: bytes

    @property
    def n(self) -> int:
        return int(self.gens.shape[0])


def make_key(label: bytes, n: int, device=None) -> CommitKey:
    """n generators and a blinding generator derived from ``label`` on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    gens = group.derive_generators(b"zkdl/gens/" + label, n, dev)
    h = group.derive_generators(b"zkdl/blind/" + label, 1, dev)[0]
    return CommitKey(gens, h, label)


def commit_many(rows) -> torch.Tensor:
    """R Pedersen commitments in ONE row-batched MSM -> (R,) elements.

    ``rows`` is a list of ``(key, values_mont, blind)`` triples; rows may
    use different keys and lengths.  Each row's blind rides as one extra
    ``(h, blind)`` term of its own MSM, so row r equals
    ``commit(key_r, values_r, blind_r)``; rows are not padded."""
    pts, exps, ids = [], [], []
    for r, (key, v, blind) in enumerate(rows):
        v = v.reshape(-1)
        n = v.shape[0]
        assert n <= key.n, (n, key.n)
        pts += [key.gens[:n], key.h.reshape(1)]
        exps += [from_mont(FQ, v),
                 group.exps_from_ints([int(blind) % Q], v.device)]
        ids.append(torch.full((n + 1,), r, dtype=torch.int64,
                              device=v.device))
    return group.msm_ragged(torch.cat(pts), torch.cat(exps), torch.cat(ids),
                            len(rows))


def commit(key: CommitKey, values_mont: torch.Tensor, blind: int,
           nbits: int = 61) -> torch.Tensor:
    """Commit to an FQ vector (Montgomery form). Returns a group element."""
    values_mont = values_mont.reshape(-1)
    n = values_mont.shape[0]
    assert n <= key.n, (n, key.n)
    acc = group.msm(key.gens[:n], from_mont(FQ, values_mont), nbits=nbits)
    if blind:
        acc = group.g_mul(acc, group.g_pow_int(key.h, blind))
    return acc


def commit_bits(key: CommitKey, bits, blind: int) -> torch.Tensor:
    """Commit to a 0/1 vector: selection product, no exponentiation."""
    bits = torch.as_tensor(bits, device=key.gens.device).reshape(-1)
    acc = group.msm_bits(key.gens[: bits.shape[0]], bits)
    if blind:
        acc = group.g_mul(acc, group.g_pow_int(key.h, blind))
    return acc


def commit_ints(key: CommitKey, ints, blind: int,
                nbits: int = 61) -> torch.Tensor:
    """Commit to python/np ints (taken mod q)."""
    exps = group.exps_from_ints(
        [int(v) for v in np.asarray(ints, dtype=object).reshape(-1)],
        key.gens.device)
    acc = group.msm(key.gens[: exps.shape[0]], exps, nbits=nbits)
    if blind:
        acc = group.g_mul(acc, group.g_pow_int(key.h, blind))
    return acc
