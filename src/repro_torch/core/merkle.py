"""Proofs of training-set (non-)membership (Section 4.4 / Appendix B).

A sparse Merkle tree over the hashes of per-data-point Pedersen
commitments.  The tree T_D = Tree(H_D) + Frontier(H_D): every internal
node has both children; leaves are either data hashes (value = the
commitment) or frontier nodes (value = epsilon).  Non-membership of a
point is proven by exhibiting a frontier node that prefixes its hash.

Implements Protocols 3 (prover) and 4 (verifier) and supports md5 / sha1 /
sha256 as in Table 3 of the paper.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Dict, Iterable, List, Optional, Set, Tuple

EPSILON = b""


def _hash_fn(name: str):
    return getattr(hashlib, name)


def hash_bits(data: bytes, hash_name: str) -> str:
    """Hash -> bit string (the leaf identifier / path)."""
    digest = _hash_fn(hash_name)(data).digest()
    return "".join(f"{b:08b}" for b in digest)


def _node_hash(left: bytes, right: bytes, hash_name: str) -> bytes:
    h = _hash_fn(hash_name)()
    h.update(b"L%d:" % len(left))
    h.update(left)
    h.update(b"R%d:" % len(right))
    h.update(right)
    return h.digest()


def _frontier(leaves: Set[str]) -> Set[str]:
    """Nodes not on any leaf path whose parent is (or is the root)."""
    tree: Set[str] = {""}
    for leaf in leaves:
        for i in range(1, len(leaf) + 1):
            tree.add(leaf[:i])
    out: Set[str] = set()
    for node in tree:
        for b in "01":
            child = node + b
            if child not in tree and not any(
                    leaf.startswith(child) or child.startswith(leaf)
                    for leaf in leaves):
                # child is off-tree; include it iff truly not covering a leaf
                out.add(child)
    # keep only children of tree nodes that are not themselves in tree
    return {v for v in out if v[:-1] in tree and v not in tree}


def merkle_root(values: Dict[str, bytes], hash_name: str) -> bytes:
    """Algorithm 2: roll up leaf values (keyed by bit-string id) to the root.

    Aborts (ValueError) if any node's sibling is missing.
    """
    if not values:
        raise ValueError("empty leaf set")
    if set(values) == {""}:
        return values[""]
    work = dict(values)
    depth = max(len(k) for k in work)
    for k in range(depth, 0, -1):
        level = [s for s in work if len(s) == k]
        parents: Dict[str, bytes] = {}
        done = set()
        for s in level:
            if s in done:
                continue
            sib = s[:-1] + ("1" if s[-1] == "0" else "0")
            if sib not in work:
                raise ValueError(f"missing sibling of {s}")
            done.add(s); done.add(sib)
            l_, r_ = (s, sib) if s[-1] == "0" else (sib, s)
            parents[s[:-1]] = _node_hash(work[l_], work[r_], hash_name)
        for s in level:
            del work[s]
        for p, v in parents.items():
            if p in work:
                raise ValueError(f"non-disjoint union at {p}")
            work[p] = v
    return work[""]


def _pack_id(bits: str) -> bytes:
    """Bit-string node id -> (u16 bit length, MSB-first packed bytes)."""
    nbits = len(bits)
    padded = bits + "0" * (-nbits % 8)
    packed = bytes(int(padded[i:i + 8], 2) for i in range(0, len(padded), 8))
    return struct.pack("<H", nbits) + packed


class MembershipProofDecodeError(ValueError):
    pass


class _ProofReader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise MembershipProofDecodeError("truncated membership proof")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def node_id(self) -> str:
        nbits = self.u16()
        packed = self.take((nbits + 7) // 8)
        bits = "".join(f"{b:08b}" for b in packed)
        return bits[:nbits]


MEMBERSHIP_PROOF_MAGIC = b"ZKMP"
MEMBERSHIP_PROOF_VERSION = 1


@dataclasses.dataclass
class MembershipProof:
    """Protocol 3 output: hashes split by membership + released node values."""
    included: List[str]
    excluded: List[str]
    frontier_exc: List[str]            # F^exc: frontier prefixes of excluded
    node_values: Dict[str, bytes]      # values on Tree(inc u F^exc) frontier

    def size_nodes(self) -> int:
        return len(self.node_values) + len(self.frontier_exc)

    def to_bytes(self) -> bytes:
        """Canonical encoding so audits verify in a fresh process from
        bytes alone (node ids are bit strings; values are raw bytes)."""
        out = [MEMBERSHIP_PROOF_MAGIC,
               struct.pack("<H", MEMBERSHIP_PROOF_VERSION)]
        for group in (self.included, self.excluded, self.frontier_exc):
            out.append(struct.pack("<I", len(group)))
            out.extend(_pack_id(h) for h in group)
        out.append(struct.pack("<I", len(self.node_values)))
        for nid in sorted(self.node_values):
            val = self.node_values[nid]
            out.append(_pack_id(nid))
            out.append(struct.pack("<I", len(val)))
            out.append(val)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "MembershipProof":
        r = _ProofReader(data)
        if r.take(4) != MEMBERSHIP_PROOF_MAGIC:
            raise MembershipProofDecodeError("bad membership-proof magic")
        ver = r.u16()
        if ver != MEMBERSHIP_PROOF_VERSION:
            raise MembershipProofDecodeError(
                f"unsupported membership-proof version {ver}")
        groups = []
        for _ in range(3):
            groups.append([r.node_id() for _ in range(r.u32())])
        node_values: Dict[str, bytes] = {}
        for _ in range(r.u32()):
            nid = r.node_id()
            node_values[nid] = r.take(r.u32())
        if r.off != len(data):
            raise MembershipProofDecodeError("trailing bytes")
        return cls(included=groups[0], excluded=groups[1],
                   frontier_exc=groups[2], node_values=node_values)


class MerkleTree:
    """Trainer-side tree over {hash(com_d)} with stored node values."""

    def __init__(self, commitments: Iterable[bytes], hash_name: str = "sha256"):
        self.hash_name = hash_name
        self.leaf_value: Dict[str, bytes] = {}
        for com in commitments:
            hid = hash_bits(com, hash_name)
            self.leaf_value[hid] = com
        self.leaves: Set[str] = set(self.leaf_value)
        self.frontier = self._compute_frontier()
        values: Dict[str, bytes] = dict(self.leaf_value)
        for f in self.frontier:
            values[f] = EPSILON
        self.values = self._fill(values)
        self.root = self.values[""]

    def _compute_frontier(self) -> Set[str]:
        tree: Set[str] = {""}
        for leaf in self.leaves:
            for i in range(1, len(leaf) + 1):
                tree.add(leaf[:i])
        out: Set[str] = set()
        for node in tree:
            if node in self.leaves:
                continue
            for b in "01":
                child = node + b
                if child not in tree:
                    out.add(child)
        return out

    def _fill(self, values: Dict[str, bytes]) -> Dict[str, bytes]:
        # bucket nodes by depth once and sweep bottom-up: each node is
        # touched O(1) times (the per-level rescan of the whole pending
        # set made dataset-scale trees quadratic in practice)
        out = dict(values)
        by_len: Dict[int, List[str]] = {}
        for n in out:
            by_len.setdefault(len(n), []).append(n)
        for k in range(max(by_len, default=0), 0, -1):
            for s in by_len.get(k, ()):
                parent = s[:-1]
                sib = parent + ("1" if s[-1] == "0" else "0")
                if parent in out or sib not in out:
                    continue
                l_, r_ = (s, sib) if s[-1] == "0" else (sib, s)
                out[parent] = _node_hash(out[l_], out[r_], self.hash_name)
                by_len.setdefault(k - 1, []).append(parent)
        return out

    # -- Protocol 3 ---------------------------------------------------------
    def prove_membership(self, queried: Iterable[bytes]) -> MembershipProof:
        h_e = [hash_bits(c, self.hash_name) for c in queried]
        inc = [h for h in h_e if h in self.leaves]
        exc = [h for h in h_e if h not in self.leaves]
        f_exc: Set[str] = set()
        for h in exc:
            # walk h's prefixes instead of scanning the frontier set
            # (the frontier holds ~n*hash_bits nodes at dataset scale)
            pre = next((h[:i] for i in range(1, len(h) + 1)
                        if h[:i] in self.frontier), None)
            if pre is None:
                raise AssertionError("frontier must cover every non-member")
            f_exc.add(pre)
        # release the anchors plus every sibling along their paths to the
        # root (= Frontier(H_E^inc u F^exc) restricted to T_D, whose nodes
        # all exist because every internal node of T_D has two children)
        anchor = set(inc) | f_exc
        path_nodes: Set[str] = set()
        for a in anchor:
            for i in range(0, len(a) + 1):
                path_nodes.add(a[:i])
        release: Dict[str, bytes] = {a: self.values[a] for a in anchor}
        for node in path_nodes:
            if node == "":
                continue
            sib = node[:-1] + ("1" if node[-1] == "0" else "0")
            if sib not in path_nodes:
                release[sib] = self.values[sib]
        return MembershipProof(included=inc, excluded=exc,
                               frontier_exc=sorted(f_exc),
                               node_values=release)


def verify_membership(queried: Iterable[bytes], root: bytes,
                      proof: MembershipProof, hash_name: str = "sha256") -> bool:
    """Protocol 4: data-owner verification against the endorsed root."""
    h_e = [hash_bits(c, hash_name) for c in queried]
    if sorted(h_e) != sorted(proof.included + proof.excluded):
        return False
    if set(proof.included) & set(proof.excluded):
        return False
    # every excluded hash must be covered by a released frontier node = eps
    for h in proof.excluded:
        pre = next((f for f in proof.frontier_exc if h.startswith(f)), None)
        if pre is None:
            return False
        if proof.node_values.get(pre, None) != EPSILON:
            return False
    # every included hash must carry its commitment value whose hash matches
    for h in proof.included:
        val = proof.node_values.get(h)
        if val is None or hash_bits(val, hash_name) != h:
            return False
    try:
        rebuilt = merkle_root(dict(proof.node_values), hash_name)
    except ValueError:
        return False
    return rebuilt == root
