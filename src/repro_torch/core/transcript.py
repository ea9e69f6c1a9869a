"""Fiat-Shamir transcript for the zkDL interactive protocols.

Messages are canonical python ints (standard-form field / group elements);
challenges are derived by hashing the running state with SHA-256.  Both the
prover and verifier drive an identical transcript, which makes every
interactive sumcheck / IPA below non-interactive in the random-oracle model.
"""
from __future__ import annotations

import hashlib


class Transcript:
    def __init__(self, label: bytes = b"zkdl"):
        self._state = hashlib.sha256(label).digest()
        self._counter = 0

    def absorb_bytes(self, label: bytes, data: bytes) -> None:
        h = hashlib.sha256()
        h.update(self._state)
        h.update(len(label).to_bytes(4, "little"))
        h.update(label)
        h.update(len(data).to_bytes(8, "little"))
        h.update(data)
        self._state = h.digest()

    def absorb_int(self, label: bytes, value: int) -> None:
        self.absorb_bytes(label, int(value).to_bytes(32, "little", signed=False))

    def absorb_ints(self, label: bytes, values) -> None:
        data = b"".join(int(v).to_bytes(32, "little") for v in values)
        self.absorb_bytes(label, data)

    def challenge_int(self, label: bytes, modulus: int) -> int:
        h = hashlib.sha256()
        h.update(self._state)
        h.update(b"challenge")
        h.update(len(label).to_bytes(4, "little"))
        h.update(label)
        h.update(self._counter.to_bytes(8, "little"))
        self._counter += 1
        digest = h.digest() + hashlib.sha256(h.digest()).digest()
        return int.from_bytes(digest, "little") % modulus

    def challenge_ints(self, label: bytes, modulus: int, n: int):
        return [self.challenge_int(label + b"/%d" % i, modulus) for i in range(n)]
