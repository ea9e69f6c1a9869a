"""An independent reading of an aggregated proof's bytes.

The proof's first claims are the openings a1..a6: the multilinear
extensions of the stacked Z'', B_{Q-1}, R_Z, G_A', R_GA and G_W tensors
of the window's T steps, at points drawn by Fiat-Shamir from the
proof's own commitments.  This module parses the META, COMS and OPEN
sections of the canonical encoding, replays the transcript (SHA-256
over the label and the commitments) to draw those points, evaluates
the reference's own tensors there over the proof field
q = 2^61 - 5283, and counts the openings that differ.  So a proof
passes only if it binds exactly the witness the reference computed.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Sequence

import torch

from zkbench.work.geometry import Geometry

Q = (1 << 61) - 5283
_C = (1 << 61) - Q                   # 2^61 = C mod q
_M61 = (1 << 61) - 1
#: (opening, slot, point) of the six openings the reference can read
OPENINGS = (("a1", "zpp", "f"), ("a2", "bq", "f"), ("a3", "rz", "f"),
            ("a4", "gap", "b"), ("a5", "rga", "b"), ("a6", "gw", "w"))


class Transcript:
    """The protocol's SHA-256 Fiat-Shamir transcript."""

    def __init__(self, label: bytes):
        self._state = hashlib.sha256(label).digest()
        self._counter = 0

    def absorb_ints(self, label: bytes, values: Sequence[int]) -> None:
        data = b"".join(int(v).to_bytes(32, "little") for v in values)
        h = hashlib.sha256(self._state)
        h.update(len(label).to_bytes(4, "little") + label)
        h.update(len(data).to_bytes(8, "little") + data)
        self._state = h.digest()

    def challenge(self, label: bytes) -> int:
        h = hashlib.sha256(self._state)
        h.update(b"challenge" + len(label).to_bytes(4, "little") + label)
        h.update(self._counter.to_bytes(8, "little"))
        self._counter += 1
        digest = h.digest() + hashlib.sha256(h.digest()).digest()
        return int.from_bytes(digest, "little") % Q

    def challenges(self, tag: bytes, n: int) -> List[int]:
        return [self.challenge(tag + b"/%d" % i) for i in range(n)]


# -- the canonical encoding's first three sections -------------------------

def parse(raw: bytes) -> dict:
    """{"n_steps", "coms" (every commitment in transcript order),
    "n_x", "openings"} of a proof; ValueError when malformed."""
    if raw[:4] != b"ZKDL" or len(raw) < 6:
        raise ValueError("not a zkDL proof")
    pos, sections = 6, {}
    for tag in (1, 2, 3):
        if pos + 5 > len(raw) or raw[pos] != tag:
            raise ValueError(f"section {tag} missing")
        n = struct.unpack_from("<I", raw, pos + 1)[0]
        sections[tag] = raw[pos + 5: pos + 5 + n]
        pos += 5 + n
    n_steps = struct.unpack_from("<I", sections[1])[0]
    body, p = sections[2], 0

    def take(fmt):
        nonlocal p
        out = struct.unpack_from(fmt, body, p)
        p += struct.calcsize(fmt)
        return out[0]

    n_x = take("<I")
    coms = [take("<Q") for _ in range(n_x)]
    for _ in range(take("<H")):
        n = take("<H")
        p += n                               # the slot's name
        coms.append(take("<Q"))
    coms += [take("<Q") for _ in range(4)]   # the validity commitments
    body, p = sections[3], 0
    openings = {}
    for _ in range(take("<I")):
        n = take("<H")
        name = body[p: p + n].decode()
        p += n
        openings[name] = take("<Q")
    return {"n_steps": n_steps, "coms": coms, "n_x": n_x,
            "openings": openings}


def draw_points(coms: Sequence[int], geo: Geometry,
                label: bytes) -> Dict[str, List[int]]:
    """The three opening points, variables little-endian (element
    columns first, then rows, then the (step, node) slot)."""
    t = Transcript(label)
    t.absorb_ints(b"coms", coms)
    la_c = geo.la - geo.lb
    u = {}
    for tag, n in (("u_r", geo.lb), ("u_c", la_c), ("u_r2", geo.lb),
                   ("u_c2", la_c), ("u_i", geo.lw - geo.lj),
                   ("u_j", geo.lj), ("u_sf", geo.ls), ("u_sb", geo.ls),
                   ("u_sw", geo.ls)):
        u[tag] = t.challenges(tag.encode(), n)
    return {"f": u["u_c"] + u["u_r"] + u["u_sf"],
            "b": u["u_c2"] + u["u_r2"] + u["u_sb"],
            "w": u["u_j"] + u["u_i"] + u["u_sw"]}


# -- arithmetic mod q on int64 tensors --------------------------------------

def _reduce(v: torch.Tensor) -> torch.Tensor:
    """[0, 2^63) -> [0, q), from 2^61 = C (mod q)."""
    v = (v >> 61) * _C + (v & _M61)
    return torch.where(v >= Q, v - Q, v)


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    return torch.where(s >= Q, s - Q, s)


def _shl(v: torch.Tensor, s: int) -> torch.Tensor:
    """v * 2^s mod q for v in [0, q) and s <= 32."""
    return _reduce((v >> (61 - s)) * _C + ((v & ((1 << (61 - s)) - 1)) << s))


def mul_scalar(v: torch.Tensor, u: int) -> torch.Tensor:
    """v * u mod q for v in [0, q) and an int u in [0, q): u in 16-bit
    limbs, v in 32-bit halves, so no partial product passes 2^63."""
    hi, lo = v >> 32, v & 0xFFFFFFFF
    acc = torch.zeros_like(v)
    for k in (3, 2, 1, 0):
        limb = (u >> (16 * k)) & 0xFFFF
        part = _add(_shl(_reduce(hi * limb), 32), _reduce(lo * limb))
        acc = _add(_shl(acc, 16), part)
    return acc


def mle_eval(table: torch.Tensor, point: Sequence[int]) -> int:
    """The multilinear extension of a flat integer table (entries below
    2^62 in magnitude, length 2^len(point)) at ``point``; variable j is
    bit j of the index."""
    t = torch.remainder(table.reshape(-1).to(torch.int64), Q)
    if t.numel() != 1 << len(point):
        raise ValueError("table length does not match the point")
    for u in point:
        lo, hi = t[0::2], t[1::2]
        diff = hi - lo
        t = _add(lo, mul_scalar(torch.where(diff < 0, diff + Q, diff),
                                int(u) % Q))
    return int(t[0])


# -- the reference's stacked tensors ----------------------------------------

def _pad2d(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = torch.zeros((rows, cols), dtype=torch.int64, device=t.device)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def stack(geo: Geometry, steps: List[Dict[str, list]], slot: str
          ) -> torch.Tensor:
    """One slot's tensors of the window's T steps, stacked as the
    commitment lays them out: each (step, node) slot holds its tensor
    zero-padded to powers of two, flattened row-major at the slot's
    start; node fastest, then step."""
    L, pads, B = geo.n_layers, geo.pads, geo.batch
    if slot == "gw":
        area, shape = geo.w_elem, lambda l: (pads[l + 1], pads[l])
    else:
        area, shape = geo.d_elem, lambda l: (B, pads[l + 1])
    dev = steps[0]["gw"][0].device
    out = torch.zeros((geo.t_pad, geo.l_pad, area), dtype=torch.int64,
                      device=dev)
    for t, tensors in enumerate(steps):
        for l, v in enumerate(tensors[slot]):
            if v is not None:
                rows, cols = shape(l)
                out[t, l, : rows * cols] = _pad2d(v, rows, cols).reshape(-1)
    return out.reshape(-1)


def check_proof(raw: bytes, geo: Geometry, steps: List[Dict[str, list]],
                label: bytes) -> List[str]:
    """The names of what in ``raw`` differs from the reference's
    ``steps`` (the T steps' tensors from `sgd.sgd_step`): an empty list
    for a proof of exactly that witness."""
    try:
        p = parse(raw)
    except (ValueError, struct.error, UnicodeDecodeError):
        return ["encoding"]
    bad = []
    if p["n_steps"] != geo.n_steps:
        bad.append("n_steps")
    if p["n_x"] != geo.n_steps * geo.batch:
        bad.append("n_x")
    if bad:
        return bad
    points = draw_points(p["coms"], geo, label)
    for name, slot, pt in OPENINGS:
        want = mle_eval(stack(geo, steps, slot), points[pt])
        if p["openings"].get(name) != want:
            bad.append(name)
    return bad

