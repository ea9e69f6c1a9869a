"""Canonical byte encoding for aggregated proofs and verifying keys.

This is the deployment contract: the trainer writes ``proof.bin`` (and
once, ``vk.bin``); the verifier — any process, any machine — rebuilds
the proof object and the key material from bytes alone and runs the
standalone verifier.  Nothing here touches live session state.

Layout (all integers little-endian):

    proof:  magic b"ZKDL" | u16 version | sections
    vk:     magic b"ZKVK" | u16 version | quant/steps | graph nodes

Every proof section is framed ``u8 tag | u32 length | payload`` and
appears exactly once, in tag order:

    1 META      n_steps
    2 COMS      per-sample x commitments, schema-slot commitments
                (name-keyed, in the graph's commit_slots order — the
                transcript absorption order), the four validity
                commitments (com_b_ip, com_bq1, com_bq1p, com_br_ip)
    3 OPEN      claim openings, name-keyed
    4 SC        per-family bucket sumchecks + the anchor sumcheck
    5 FINALS    per-family bucket finals + claim splits + anchor finals
    6 IPA       the ONE merged pair IPA: every direct-sum opening block
                AND both zkReLU validity statements (v3; v2 carried the
                two validity IPAs in a separate section 7, v1 a
                name-keyed dict of per-tensor IPAs)

Scalars are 8-byte words: both the proof field (61-bit) and the group
field (62-bit) fit.  The encoding is canonical — encode(decode(b)) == b
and decode(encode(p)) == p — so byte digests are stable and any
single-byte tamper either fails framing (`ProofDecodeError`) or changes
a transcript value and is rejected by verification.

Version negotiation is explicit: v3 readers reject v1/v2 streams (whose
separate opening/validity arguments and key layouts no longer exist)
with a dedicated `ProofDecodeError` naming the migration, and reject
unknown future versions rather than guessing.
"""
from __future__ import annotations

import io
import struct
from typing import Dict, List

from repro_torch.core import ipa, zkrelu
from repro_torch.core.sumcheck import SumcheckProof

MAGIC_PROOF = b"ZKDL"
MAGIC_VK = b"ZKVK"
# v3: the two standalone zkReLU validity IPAs folded into the single
# direct-sum opening (now a pair IPA over the merged basis) and the
# VALIDITY section disappeared; keys grew the merged/h_open bases and a
# fresh bq slice — v1/v2 bytes (and their verifying keys) cannot verify
# under v3 keys, so decode refuses them instead of mis-verifying
VERSION = 3

_SECTIONS = ("META", "COMS", "OPEN", "SC", "FINALS", "IPA")
FAMILIES = ("fwd", "bwd", "gw")


class ProofDecodeError(ValueError):
    """Malformed / truncated / version-mismatched byte stream."""


def _check_version(ver: int, what: str) -> None:
    if ver == VERSION:
        return
    if ver == 1:
        raise ProofDecodeError(
            f"{what} format v1 (per-slot IPA openings) is no longer "
            "supported: v3 aggregates every opening AND the zkReLU "
            "validity statements into one merged pair IPA over a new "
            "key layout — re-prove under v3 keys")
    if ver == 2:
        raise ProofDecodeError(
            f"{what} format v2 (separate zkReLU validity IPAs) is no "
            "longer supported: v3 folds the validity statements into "
            "the single direct-sum pair IPA and drops the VALIDITY "
            "section — re-prove under v3 keys")
    raise ProofDecodeError(f"unsupported {what} version {ver} "
                           f"(this decoder speaks v{VERSION})")


# -- primitives -------------------------------------------------------------

def _w_u8(b: io.BytesIO, v: int) -> None:
    b.write(struct.pack("<B", v))


def _w_u16(b: io.BytesIO, v: int) -> None:
    b.write(struct.pack("<H", v))


def _w_u32(b: io.BytesIO, v: int) -> None:
    b.write(struct.pack("<I", v))


def _w_scalar(b: io.BytesIO, v: int) -> None:
    if not 0 <= v < (1 << 64):
        raise ValueError(f"scalar out of u64 range: {v}")
    b.write(struct.pack("<Q", v))


def _w_scalars(b: io.BytesIO, vs: List[int], count: str = "u32") -> None:
    (_w_u32 if count == "u32" else _w_u16)(b, len(vs))
    for v in vs:
        _w_scalar(b, v)


def _w_str(b: io.BytesIO, s: str) -> None:
    raw = s.encode()
    _w_u16(b, len(raw))
    b.write(raw)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ProofDecodeError("truncated stream")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return struct.unpack("<B", self.take(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def scalar(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def scalars(self, count: str = "u32") -> List[int]:
        n = self.u32() if count == "u32" else self.u16()
        if self.pos + 8 * n > len(self.data):    # framing sanity first
            raise ProofDecodeError("implausible vector length")
        return [self.scalar() for _ in range(n)]

    def str_(self) -> str:
        n = self.u16()
        try:
            return self.take(n).decode()
        except UnicodeDecodeError as exc:
            raise ProofDecodeError("bad string") from exc

    def done(self) -> bool:
        return self.pos == len(self.data)


# -- sumcheck / ipa helpers -------------------------------------------------

def _w_sumcheck(b: io.BytesIO, sc: SumcheckProof) -> None:
    _w_u16(b, len(sc.messages))
    for msg in sc.messages:
        _w_u8(b, len(msg))
        for v in msg:
            _w_scalar(b, v)


def _r_sumcheck(r: _Reader) -> SumcheckProof:
    n_rounds = r.u16()
    msgs = []
    for _ in range(n_rounds):
        k = r.u8()
        msgs.append([r.scalar() for _ in range(k)])
    return SumcheckProof(messages=msgs)


def _w_ipa(b: io.BytesIO, p: ipa.IpaProof) -> None:
    if len(p.ls) != len(p.rs):
        raise ValueError("IPA L/R length mismatch")
    _w_u16(b, len(p.ls))
    for v in p.ls:
        _w_scalar(b, v)
    for v in p.rs:
        _w_scalar(b, v)
    _w_u8(b, len(p.sigma))
    for v in p.sigma:
        _w_scalar(b, v)


def _r_ipa(r: _Reader) -> ipa.IpaProof:
    n = r.u16()
    ls = [r.scalar() for _ in range(n)]
    rs = [r.scalar() for _ in range(n)]
    k = r.u8()
    return ipa.IpaProof(ls=ls, rs=rs, sigma=[r.scalar() for _ in range(k)])


# -- proof ------------------------------------------------------------------

def encode_proof(proof) -> bytes:
    """`AggregatedProof` -> canonical bytes (versioned header)."""
    out = io.BytesIO()
    out.write(MAGIC_PROOF)
    _w_u16(out, VERSION)

    def section(tag: int, body: io.BytesIO) -> None:
        raw = body.getvalue()
        _w_u8(out, tag)
        _w_u32(out, len(raw))
        out.write(raw)

    b = io.BytesIO()                                   # 1 META
    _w_u32(b, proof.n_steps)
    section(1, b)

    b = io.BytesIO()                                   # 2 COMS
    _w_scalars(b, proof.coms.x)
    _w_u16(b, len(proof.coms.slots))
    for name, v in proof.coms.slots.items():           # schema order
        _w_str(b, name)
        _w_scalar(b, v)
    val = proof.coms.validity
    for v in (val.com_b_ip, val.com_bq1, val.com_bq1p, val.com_br_ip):
        _w_scalar(b, v)
    section(2, b)

    b = io.BytesIO()                                   # 3 OPEN
    _w_u32(b, len(proof.openings))
    for name in sorted(proof.openings):
        _w_str(b, name)
        _w_scalar(b, proof.openings[name])
    section(3, b)

    b = io.BytesIO()                                   # 4 SC
    for fam in FAMILIES:
        scs = getattr(proof, f"sc_{fam}")
        _w_u16(b, len(scs))
        for sc in scs:
            _w_sumcheck(b, sc)
    _w_sumcheck(b, proof.sc_anchor)
    section(4, b)

    b = io.BytesIO()                                   # 5 FINALS
    for fam in FAMILIES:
        finals = getattr(proof, f"{fam}_finals")
        _w_u16(b, len(finals))
        for f in finals:
            _w_scalars(b, f)
        _w_scalars(b, getattr(proof, f"{fam}_claims"), count="u16")
    _w_scalars(b, proof.anchor_finals, count="u16")
    section(5, b)

    b = io.BytesIO()                                   # 6 IPA (merged)
    _w_ipa(b, proof.ipa_agg)
    section(6, b)

    return out.getvalue()


def decode_proof(data: bytes):
    """Canonical bytes -> `AggregatedProof` (raises `ProofDecodeError`)."""
    from repro_torch.core.pipeline.session import (AggregatedProof,
                                             SessionCommitments)

    r = _Reader(data)
    if r.take(4) != MAGIC_PROOF:
        raise ProofDecodeError("bad magic (not a zkDL proof)")
    _check_version(r.u16(), "proof")

    sections: Dict[int, _Reader] = {}
    for tag_want in range(1, len(_SECTIONS) + 1):
        tag = r.u8()
        if tag != tag_want:
            raise ProofDecodeError(f"expected section {tag_want}, got {tag}")
        sections[tag] = _Reader(r.take(r.u32()))

    if not r.done():
        raise ProofDecodeError("trailing bytes after final section")

    s = sections[1]
    n_steps = s.u32()

    s = sections[2]
    x = s.scalars()
    slots = {}
    for _ in range(s.u16()):
        name = s.str_()
        slots[name] = s.scalar()
    validity_coms = zkrelu.ValidityCommitments(
        com_b_ip=s.scalar(), com_bq1=s.scalar(), com_bq1p=s.scalar(),
        com_br_ip=s.scalar())
    coms = SessionCommitments(x=x, slots=slots, validity=validity_coms)

    s = sections[3]
    openings = {}
    for _ in range(s.u32()):
        name = s.str_()
        openings[name] = s.scalar()

    s = sections[4]
    scs = {fam: [_r_sumcheck(s) for _ in range(s.u16())]
           for fam in FAMILIES}
    sc_anchor = _r_sumcheck(s)

    s = sections[5]
    finals, claims = {}, {}
    for fam in FAMILIES:
        finals[fam] = [s.scalars() for _ in range(s.u16())]
        claims[fam] = s.scalars(count="u16")
    anchor_finals = s.scalars(count="u16")

    s = sections[6]
    ipa_agg = _r_ipa(s)

    for tag, sec in sections.items():
        if not sec.done():
            raise ProofDecodeError(
                f"trailing bytes in section {_SECTIONS[tag - 1]}")

    return AggregatedProof(
        coms=coms, openings=openings,
        sc_fwd=scs["fwd"], sc_bwd=scs["bwd"], sc_gw=scs["gw"],
        sc_anchor=sc_anchor,
        fwd_finals=finals["fwd"], bwd_finals=finals["bwd"],
        gw_finals=finals["gw"],
        fwd_claims=claims["fwd"], bwd_claims=claims["bwd"],
        gw_claims=claims["gw"],
        anchor_finals=anchor_finals, ipa_agg=ipa_agg, n_steps=n_steps)


# -- verifying key ----------------------------------------------------------

def encode_vk(vk) -> bytes:
    """`VerifyingKey` -> bytes: the graph spec plus the quantization and
    aggregation-window parameters.  Generators are NOT serialized — they
    re-derive deterministically from the geometry on load, so vk.bin is
    a few hundred bytes for any model size."""
    cfg = vk.cfg
    out = io.BytesIO()
    out.write(MAGIC_VK)
    _w_u16(out, VERSION)
    _w_u8(out, cfg.q_bits)
    _w_u8(out, cfg.r_bits)
    _w_u32(out, cfg.n_steps)
    nodes = cfg.graph.nodes
    _w_u16(out, len(nodes))
    for n in nodes:
        _w_str(out, n.name)
        _w_str(out, n.kind)
        _w_u8(out, len(n.inputs))
        for src in n.inputs:
            _w_str(out, src)
        _w_u32(out, n.shape[0])
        _w_u32(out, n.shape[1])
        _w_u32(out, n.layer)
    return out.getvalue()


# Resource bound on vk-declared geometry (PR-8 fuzz finding): the vk is
# a TRUSTED input in the protocol, but `decode_vk` is reachable from
# attacker-supplied bytes in deployments that fetch vks by reference.
# Key material re-derives from the declared geometry, so a mutated vk
# claiming a huge graph turns `make_keys` into an unbounded hash-to-
# curve workload.  `cfg.merged_len` is pure arithmetic over the
# geometry (every derived basis — slot keys, the unified agg key, the
# zkReLU bases, the merged IPA key — is a slice of, or smaller than,
# the merged basis), so one cap on it bounds ALL generator derivation.
# 1<<22 generators is ~100x the largest geometry the benchmarks prove
# and already represents minutes of derivation work.
VK_MAX_MERGED_LEN = 1 << 22


def decode_vk(data: bytes, max_merged_len: int = VK_MAX_MERGED_LEN,
              device=None):
    """Bytes -> `VerifyingKey` (generators derive lazily on first use, on
    ``device``: the card unless the caller passes ``"cpu"``)."""
    from repro_torch.core.pipeline.api import VerifyingKey
    from repro_torch.core.pipeline.config import PipelineConfig
    from repro_torch.core.pipeline.graph import LayerGraph, LayerOp

    r = _Reader(data)
    if r.take(4) != MAGIC_VK:
        raise ProofDecodeError("bad magic (not a zkDL verifying key)")
    _check_version(r.u16(), "vk")
    q_bits, r_bits = r.u8(), r.u8()
    n_steps = r.u32()
    nodes = []
    for _ in range(r.u16()):
        name = r.str_()
        kind = r.str_()
        inputs = tuple(r.str_() for _ in range(r.u8()))
        shape = (r.u32(), r.u32())
        layer = r.u32()
        nodes.append(LayerOp(name, kind, inputs, shape, layer=layer))
    if not r.done():
        raise ProofDecodeError("trailing bytes after vk")
    try:
        graph = LayerGraph(tuple(nodes))
        cfg = PipelineConfig.from_graph(graph, q_bits=q_bits,
                                        r_bits=r_bits, n_steps=n_steps)
    except (ValueError, KeyError, AssertionError, IndexError, TypeError,
            OverflowError, ZeroDivisionError) as exc:
        # config derivation asserts geometry (>= 2 layers, pow2 batch,
        # resolvable op inputs); from attacker-supplied bytes ANY of
        # these are format errors, not bugs — the fuzz suite
        # (tests/test_proofio_fuzz.py) holds this to "ProofDecodeError
        # or clean verify-reject, never a crash"
        raise ProofDecodeError(f"invalid graph in vk: {exc}") from exc
    if cfg.merged_len > max_merged_len:
        raise ProofDecodeError(
            f"vk geometry implies a {cfg.merged_len}-generator merged key "
            f"(cap {max_merged_len}): refusing key derivation")
    return VerifyingKey(cfg=cfg, device=device)
