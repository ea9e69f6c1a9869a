"""Data-membership audits on the v3 proof format (Section 4.4).

The prover pipeline already commits every training sample: ``coms.x``
in each proof is the per-sample Pedersen commitment list, in step-major
order, absorbed into the transcript before any challenge is drawn.
This module binds those commitments into a sparse-Merkle dataset root
(`core.merkle`, Protocols 3/4) and answers the audit question

    "were these committed samples used in window W?"

from bytes alone — a ``DatasetBinding`` artifact, an auditor-held
``MembershipAudit``, and the window's ``proof_*.bin``; no session
state, no key derivation on the verifier side.

Binding layout (``dataset.bin``, magic ``ZKDB``):

    ZKDB | u16 version | str hash_name | u16 root_len | root
         | u32 n_windows | per window (ascending):
             u32 window | u64 sample_start | u32 sample_count
             | u8 digest_len | sha256(com_bytes window-concat)

The per-window digest is over the window's concatenated 8-byte-LE
commitment encodings (the exact scalar encoding of the proof format),
so a proof presented for window W must carry EXACTLY window W's sample
commitments — cross-window replay of an otherwise-honest proof fails
the digest check before any Merkle work happens.

The byte formats and checks are the reference's (`repro.audit.membership`);
``bind_service_dir`` binds a prover service's output directory
(`repro_torch.launch.serve`) as the reference's does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import time
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core import merkle

BINDING_MAGIC = b"ZKDB"
BINDING_VERSION = 1
AUDIT_MAGIC = b"ZKDM"
AUDIT_VERSION = 1
DATASET_QUERY = 0xFFFFFFFF       # wire encoding of window=-1 (whole dataset)

BINDING_FILE = "dataset.bin"


class AuditDecodeError(ValueError):
    pass


def com_to_bytes(com: int) -> bytes:
    """Canonical commitment encoding: the proof format's 8-byte LE
    scalar (proofio writes every group element this way)."""
    return struct.pack("<Q", int(com))


def sample_coms(proof_bytes: bytes) -> List[int]:
    """The per-sample data commitments of a serialized proof, step-major
    (T*B entries) — decoded, not verified."""
    from repro_torch.core.pipeline.proofio import decode_proof
    return [int(c) for c in decode_proof(proof_bytes).coms.x]


def commit_sample(pk, row, blind: int) -> int:
    """Commit one data row exactly as the session prover does (the
    per-sample ``kx`` basis) — how a data owner turns a raw sample into
    the commitment they can later audit for."""
    import numpy as np
    import torch

    from repro_torch.core import group, pedersen
    from repro_torch.core.pipeline.tables import enc_tensor

    kx = pk.keys.kx
    row = torch.as_tensor(np.asarray(row, dtype=np.int64),
                          device=kx.gens.device).reshape(-1)
    assert row.shape[0] == kx.n, (row.shape[0], kx.n)
    return int(group.decode_group(pedersen.commit(kx, enc_tensor(row),
                                                  blind)))


# -- binding artifact -------------------------------------------------------

@dataclasses.dataclass
class WindowSpan:
    start: int                   # global sample index of the window's row 0
    count: int                   # T * batch
    digest: bytes                # sha256 over the window's com bytes


@dataclasses.dataclass
class DatasetBinding:
    hash_name: str
    root: bytes
    windows: Dict[int, WindowSpan]

    @property
    def n_samples(self) -> int:
        return sum(s.count for s in self.windows.values())

    def to_bytes(self) -> bytes:
        out = [BINDING_MAGIC, struct.pack("<H", BINDING_VERSION)]
        name = self.hash_name.encode()
        out.append(struct.pack("<H", len(name)) + name)
        out.append(struct.pack("<H", len(self.root)) + self.root)
        out.append(struct.pack("<I", len(self.windows)))
        for w in sorted(self.windows):
            s = self.windows[w]
            out.append(struct.pack("<IQIB", w, s.start, s.count,
                                   len(s.digest)) + s.digest)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "DatasetBinding":
        r = _Reader(data)
        if r.take(4) != BINDING_MAGIC:
            raise AuditDecodeError("bad magic (not a dataset binding)")
        ver = r.u16()
        if ver != BINDING_VERSION:
            raise AuditDecodeError(f"unsupported binding version {ver}")
        hash_name = r.take(r.u16()).decode()
        root = r.take(r.u16())
        windows: Dict[int, WindowSpan] = {}
        for _ in range(r.u32()):
            w, start, count, dlen = struct.unpack("<IQIB", r.take(17))
            windows[w] = WindowSpan(start=start, count=count,
                                    digest=r.take(dlen))
        if not r.done():
            raise AuditDecodeError("trailing bytes after binding")
        return cls(hash_name=hash_name, root=root, windows=windows)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.off = data, 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise AuditDecodeError("truncated audit artifact")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def done(self) -> bool:
        return self.off == len(self.data)


def window_digest(coms: List[int]) -> bytes:
    return hashlib.sha256(b"".join(com_to_bytes(c) for c in coms)).digest()


def build_binding(window_coms: Dict[int, List[int]],
                  hash_name: str = "sha256"
                  ) -> Tuple[merkle.MerkleTree, DatasetBinding]:
    """Bind per-window sample commitments into one dataset root.

    Returns the (prover-held) tree and the (published) binding; windows
    get contiguous sample index ranges in ascending window order."""
    if not window_coms:
        raise ValueError("empty window set")
    leaves: List[bytes] = []
    windows: Dict[int, WindowSpan] = {}
    for w in sorted(window_coms):
        coms = window_coms[w]
        windows[w] = WindowSpan(start=len(leaves), count=len(coms),
                                digest=window_digest(coms))
        leaves.extend(com_to_bytes(c) for c in coms)
    tree = merkle.MerkleTree(leaves, hash_name)
    return tree, DatasetBinding(hash_name=hash_name, root=tree.root,
                                windows=windows)


# -- audit artifact ---------------------------------------------------------

@dataclasses.dataclass
class MembershipAudit:
    """One audit interaction: which window is claimed (-1 = dataset
    level), which commitments are queried, and the Protocol-3 proof."""
    window: int
    queried: List[bytes]
    proof: merkle.MembershipProof

    def to_bytes(self) -> bytes:
        out = [AUDIT_MAGIC, struct.pack("<H", AUDIT_VERSION),
               struct.pack("<I", DATASET_QUERY if self.window < 0
                           else self.window),
               struct.pack("<I", len(self.queried))]
        for q in self.queried:
            out.append(struct.pack("<H", len(q)) + q)
        proof = self.proof.to_bytes()
        out.append(struct.pack("<I", len(proof)) + proof)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "MembershipAudit":
        r = _Reader(data)
        if r.take(4) != AUDIT_MAGIC:
            raise AuditDecodeError("bad magic (not a membership audit)")
        ver = r.u16()
        if ver != AUDIT_VERSION:
            raise AuditDecodeError(f"unsupported audit version {ver}")
        window = r.u32()
        queried = [r.take(r.u16()) for _ in range(r.u32())]
        try:
            proof = merkle.MembershipProof.from_bytes(r.take(r.u32()))
        except merkle.MembershipProofDecodeError as exc:
            raise AuditDecodeError(f"bad membership proof: {exc}") from exc
        if not r.done():
            raise AuditDecodeError("trailing bytes after audit")
        return cls(window=-1 if window == DATASET_QUERY else window,
                   queried=queried, proof=proof)


def prove_membership(tree: merkle.MerkleTree, binding: DatasetBinding,
                     window: int, queried: Iterable[bytes]
                     ) -> MembershipAudit:
    """Protocol 3, audit-shaped: trainer answers a query batch against
    the bound dataset.  ``window=-1`` asks dataset-level membership
    only (no proof bytes needed at verify time)."""
    queried = list(queried)
    if not all(isinstance(q, (bytes, bytearray)) for q in queried):
        raise TypeError("queried commitments must be bytes "
                        "(use com_to_bytes)")
    queried = [bytes(q) for q in queried]
    if window >= 0 and window not in binding.windows:
        raise ValueError(f"window {window} not in binding")
    return MembershipAudit(window=window, queried=queried,
                           proof=tree.prove_membership(queried))


# -- verification (bytes in, verdict out) -----------------------------------

@dataclasses.dataclass
class QueryResult:
    com: bytes
    in_dataset: bool
    in_window: Optional[bool]    # None on dataset-level audits


@dataclasses.dataclass
class MembershipVerdict:
    ok: bool                     # audit artifacts consistent & verified
    reason: str                  # first failing check when not ok
    results: List[QueryResult]

    @property
    def n_members(self) -> int:
        return sum(1 for r in self.results if r.in_dataset)

    @property
    def n_window_members(self) -> int:
        return sum(1 for r in self.results if r.in_window)


def _fail(reason: str) -> MembershipVerdict:
    return MembershipVerdict(ok=False, reason=reason, results=[])


def verify_membership(binding: DatasetBinding, audit: MembershipAudit,
                      proof_bytes: Optional[bytes] = None,
                      vk=None, label: bytes = b"zkdl"
                      ) -> MembershipVerdict:
    """Protocol 4, audit-shaped: the data owner's side, from bytes.

    Checks (1) the Merkle (non-)membership proof against the endorsed
    root, and, for a window-level audit, (2) that the presented proof
    bytes carry EXACTLY the bound window's sample commitments (count +
    digest against the binding — this is what kills cross-window
    replay) and which queried commitments appear among them.  Passing
    ``vk`` additionally runs the full ``verify_bytes`` on the proof, so
    one call answers "this window verifies AND trained on these
    samples"."""
    if not merkle.verify_membership(audit.queried, binding.root,
                                    audit.proof, binding.hash_name):
        return _fail("merkle proof rejected")
    member = set(audit.proof.included)
    in_dataset = [merkle.hash_bits(q, binding.hash_name) in member
                  for q in audit.queried]

    if audit.window < 0:
        return MembershipVerdict(ok=True, reason="", results=[
            QueryResult(com=q, in_dataset=m, in_window=None)
            for q, m in zip(audit.queried, in_dataset)])

    span = binding.windows.get(audit.window)
    if span is None:
        return _fail(f"window {audit.window} not bound")
    if proof_bytes is None:
        return _fail("window-level audit requires proof bytes")
    if vk is not None:
        from repro_torch.core.pipeline.verifier import verify_bytes
        if not verify_bytes(vk, proof_bytes, label=label):
            return _fail("window proof rejected by verify_bytes")
    try:
        coms = sample_coms(proof_bytes)
    except Exception as exc:            # ProofDecodeError and kin
        return _fail(f"window proof undecodable: {exc}")
    if len(coms) != span.count:
        return _fail(f"window carries {len(coms)} samples, binding says "
                     f"{span.count}")
    if window_digest(coms) != span.digest:
        return _fail("window commitment digest mismatch (replayed or "
                     "wrong-window proof)")
    wset = {com_to_bytes(c) for c in coms}
    return MembershipVerdict(ok=True, reason="", results=[
        QueryResult(com=q, in_dataset=m, in_window=q in wset)
        for q, m in zip(audit.queried, in_dataset)])


def bind_service_dir(out_dir: str, hash_name: str = "sha256"
                     ) -> Tuple[merkle.MerkleTree, DatasetBinding]:
    """Bind every COMMITTED window of a ProverService output directory:
    writes ``dataset.bin`` next to ``vk.bin`` and records the binding
    in ``MANIFEST.jsonl`` (an event line without a ``window`` key, which
    `serve.read_manifest` ignores by design)."""
    from repro_torch.launch import serve

    man = serve.read_manifest(out_dir)
    committed = sorted(w for w, rec in man.items()
                       if rec.get("status") == "COMMITTED")
    if not committed:
        raise ValueError(f"no COMMITTED windows in {out_dir}")
    window_coms = {}
    for w in committed:
        with open(os.path.join(out_dir, f"proof_{w:06d}.bin"), "rb") as f:
            window_coms[w] = sample_coms(f.read())
    tree, binding = build_binding(window_coms, hash_name)

    path = os.path.join(out_dir, BINDING_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(binding.to_bytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)

    line = json.dumps({"event": "DATASET_BINDING",
                       "hash": hash_name,
                       "root": binding.root.hex(),
                       "n_windows": len(binding.windows),
                       "n_samples": binding.n_samples,
                       "ts": time.time()})
    with open(os.path.join(out_dir, serve.MANIFEST), "a") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())
    return tree, binding
