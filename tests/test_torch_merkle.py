"""The port's Merkle membership proofs against the reference's.

`repro_torch.core.merkle` is a copy of `repro.core.merkle` (hashlib
only): for the cases of tests/test_merkle.py and every hash name of
Table 3, both must give the same root and the same proof bytes, and
each side's verifier must accept the other's proofs.
"""
import numpy as np
import pytest

from repro.core import merkle as ref_merkle
from repro_torch.core import merkle


def make_commitments(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


#: case -> (n leaves, seed, queried commitments given the leaves), the
#: shapes of tests/test_merkle.py
CASES = {
    "members_and_outsiders": (50, 0,
                              lambda d: d[:5] + make_commitments(5, 99)),
    "bytes_roundtrip": (30, 4, lambda d: d[:3] + make_commitments(3, 123)),
    "all_outsiders": (200, 5, lambda d: make_commitments(20, 6)),
    "all_members": (200, 5, lambda d: d[:20]),
    "one_outsider": (16, 3, lambda d: make_commitments(1, 4)),
    "one_member": (20, 1, lambda d: d[:1]),
}


@pytest.mark.parametrize("hash_name", ["md5", "sha1", "sha256"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_roots_and_proof_bytes_match_reference(case, hash_name):
    n, seed, query = CASES[case]
    data = make_commitments(n, seed)
    queried = query(data)
    tree = merkle.MerkleTree(data, hash_name)
    ref_tree = ref_merkle.MerkleTree(data, hash_name)
    assert tree.root == ref_tree.root
    assert [merkle.hash_bits(q, hash_name) for q in queried] == \
        [ref_merkle.hash_bits(q, hash_name) for q in queried]
    proof = tree.prove_membership(queried)
    raw = proof.to_bytes()
    assert raw == ref_tree.prove_membership(queried).to_bytes()
    assert merkle.verify_membership(queried, tree.root, proof, hash_name)
    assert ref_merkle.verify_membership(
        queried, ref_tree.root, ref_merkle.MembershipProof.from_bytes(raw),
        hash_name)
    assert merkle.MembershipProof.from_bytes(raw).to_bytes() == raw


def test_rejects_lying_and_forged_exclusion():
    data = make_commitments(20, seed=1)
    tree = merkle.MerkleTree(data, "sha256")
    member = data[0]
    proof = tree.prove_membership([member])
    h = merkle.hash_bits(member, "sha256")
    proof.included.remove(h)
    proof.excluded.append(h)
    assert not merkle.verify_membership([member], tree.root, proof, "sha256")

    outsider = make_commitments(1, seed=4)[0]
    proof = tree.prove_membership([outsider])
    assert merkle.verify_membership([outsider], tree.root, proof, "sha256")
    assert not merkle.verify_membership([outsider], b"\x00" * 32, proof,
                                        "sha256")
    h = merkle.hash_bits(outsider, "sha256")
    proof.excluded.remove(h)
    proof.included.append(h)
    proof.node_values[h] = outsider
    assert not merkle.verify_membership([outsider], tree.root, proof,
                                        "sha256")


def test_malformed_proof_bytes_raise_typed_error():
    data = make_commitments(30, seed=4)
    raw = merkle.MerkleTree(data, "sha256").prove_membership(
        data[:3]).to_bytes()
    for bad in (raw[:-2], b"NOPE" + raw[4:], raw + b"\x00"):
        with pytest.raises(merkle.MembershipProofDecodeError):
            merkle.MembershipProof.from_bytes(bad)
