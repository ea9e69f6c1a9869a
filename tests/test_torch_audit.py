r"""The port's soundness audit (`repro_torch.audit`) on the CPU.

One smoke-scale ``run_audit(smoke=True, device="cpu")`` (T = 2, the
fresh-process verifier included) is shared module-wide, as in
tests/test_audit.py.  Its battery, membership artifacts and SC-BD proof
are held to values recorded once from the reference:

    ZKDL_EXEC_MODE=off JAX_PLATFORMS=cpu PYTHONPATH=src \
        python -m repro.audit run --smoke --out <scratch>/report.json \
        --dir <scratch>/art

(every attack's name, family and per-variant verdict and trace from
``report.json``; the SHA-256 of ``art/dataset.bin``,
``art/audit_000000.bin`` and ``art/proof_000000.bin``; the membership
counts and sizes, ``proof_nodes`` and the SC-BD digest).  In that
process, and in its fresh verifier process, the name
`repro.core.zkrelu.batch_inv` was bound to a host computation of the
same Montgomery-form inverses (python ``pow(x, q - 2, q)``; inverses are
unique, so every value is the same), as for tests/test_torch_train.py:
a run without it (the reference's jitted `batch_inv` is a sequential
`lax.scan`) had not finished after forty minutes on a CPU; the bound
run took four.  The port's smoke report equals that report in every
field but the timings.  The byte-format and schema cases of tests/test_audit.py
run against the port's membership module and report schema, and the
reference's own verifier and schema check read the port's artifacts.
"""
import hashlib
import json
import os

import numpy as np
import pytest

from repro.audit import membership as ref_mem
from repro.audit.report import validate_report as ref_validate_report
from repro_torch.audit import membership as mem
from repro_torch.audit.report import run_audit, validate_report
from repro_torch.core import merkle

#: (name, family, [(variant, rejected, trace), ...]) of the reference's
#: smoke battery, in registry order
REFERENCE_BATTERY = [
    ("spoofed_sgd_trajectory", "spoofed-trajectory",
     [("forged-gradient self-consistent reprove", True,
       "sumcheck: round consistency check failed")]),
    ("wrong_committed_weights", "wrong-weights",
     [("tampered final-step weight, honest reprove", True,
       "sumcheck: round consistency check failed")]),
    ("cross_slot_commit_swap", "cross-slot-claim-swap",
     [("rz<->rga commitment vectors swapped", True,
       "sumcheck: round consistency check failed")]),
    ("cross_slot_claim_swap", "cross-slot-claim-swap",
     [("rz<->rga with relocated claims (a3/a5, a7/a8)", True,
       "sumcheck: round consistency check failed")]),
    ("validity_lambda_swap", "cross-slot-claim-swap",
     [("vmain/vrem lambda weights transposed", True, "open-agg")]),
    ("bq_basis_splice", "cross-slot-claim-swap",
     [("bq slot committed under zkReLU g_col basis", True, "open-agg")]),
    ("bq_column_swap", "cross-slot-claim-swap",
     [("bq slot com <-> validity com_bq1", True,
       "sumcheck: round consistency check failed")]),
    ("cross_vk_replay", "replay",
     [("replayed under widths=(8, 4, 4) vk", True, "fwd-bucket-count"),
      ("replayed under n_steps=3 vk", True, "step-count")]),
    ("cross_label_replay", "replay",
     [("replayed under label+'/replayed'", True,
       "sumcheck: round consistency check failed")]),
    ("cross_window_replay", "replay",
     [("window-1 claim with window-0 proof bytes", True,
       "window commitment digest mismatch (replayed or wrong-window "
       "proof)"),
      ("control: honest window-1 bytes accepted", True, "")]),
    ("proof_splice", "proof-splice",
     [("IPA section grafted from a second window", True, "open-agg"),
      ("commitment section grafted from a second window", True,
       "sumcheck: round consistency check failed")]),
    ("validity_negative_gap", "validity-forgery",
     [("gap entry aliased by +2^Q, bits wrapped into range", True,
       "sumcheck: round consistency check failed")]),
    ("validity_wrong_bit_planes", "validity-forgery",
     [("b_mat[0,0] flipped, bneg kept consistent", True, "open-agg")]),
    ("forged_step_count", "meta-tamper",
     [("META n_steps incremented", True, "step-count")]),
]
REFERENCE_SHA256 = {
    "dataset.bin":
        "2ebf6ee1266e3d4159f57ac85e4d1879beb82e54d6ad4f9a4eaf0099131ae0a4",
    "audit_000000.bin":
        "71db3fe8ccdbfb016f22c0485daa73aa7e3ab255a5aed7edc1b834929f1f1b6e",
    "proof_000000.bin":
        "5520cf6ed5fab507dedddc497b858267b277543fc6751799498a7ec78dad8d38",
}
REFERENCE_MEMBERSHIP = {"n_queried": 8, "n_members": 5,
                        "n_window_members": 3, "n_non_members": 3,
                        "binding_bytes": 150, "audit_bytes": 29415,
                        "proof_nodes": 1272}
REFERENCE_SCBD = {
    "d": 32, "q_bits": 16, "size_bytes": 3200,
    "digest":
        "c1b5ba4a2c2195fb8a572272d152bac1ab1cd9aa093a5ccda8e21b8a9b8fd2c5",
}

REQUIRED_FAMILIES = {"spoofed-trajectory", "cross-slot-claim-swap",
                     "replay"}


@pytest.fixture(scope="module")
def audit(tmp_path_factory):
    work = tmp_path_factory.mktemp("audit-artifacts")
    return run_audit(smoke=True, work_dir=str(work), device="cpu"), work


@pytest.fixture
def report(audit):
    return audit[0]


def test_battery_equals_reference(report):
    got = [(o["name"], o["family"],
            [(v["variant"], v["rejected"], v["trace"])
             for v in o["variants"]]) for o in report["attacks"]]
    assert got == REFERENCE_BATTERY
    assert report["summary"]["all_rejected"]
    assert report["summary"]["n_rejected"] == 14


def test_battery_covers_required_attack_classes(report):
    names = {o["name"] for o in report["attacks"]}
    assert {"spoofed_sgd_trajectory", "cross_slot_claim_swap",
            "cross_vk_replay", "cross_window_replay",
            "proof_splice"} <= names
    assert REQUIRED_FAMILIES <= set(report["summary"]["families"])


def test_membership_artifacts_equal_reference(audit):
    report, work = audit
    m = report["membership"]
    assert m["ok"], m["reason"]
    assert {k: m[k] for k in REFERENCE_MEMBERSHIP} == REFERENCE_MEMBERSHIP
    # the fresh-process leg: `python -m repro_torch.audit
    # verify-membership` verified the same artifacts from disk
    assert m["cross_process"] == {"ran": True, "ok": True, "detail": ""}
    for name, want in REFERENCE_SHA256.items():
        with open(os.path.join(work, name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == want, name


def test_reference_verifier_reads_port_artifacts(audit):
    _, work = audit

    def read(name):
        with open(os.path.join(work, name), "rb") as f:
            return f.read()
    binding = ref_mem.DatasetBinding.from_bytes(read("dataset.bin"))
    audit_ = ref_mem.MembershipAudit.from_bytes(read("audit_000000.bin"))
    verdict = ref_mem.verify_membership(
        binding, audit_, proof_bytes=read("proof_000000.bin"))
    assert verdict.ok
    assert [r.in_dataset for r in verdict.results] == [True] * 5 + [False] * 3
    assert [r.in_window for r in verdict.results] == [True] * 3 + [False] * 5


def test_scbd_on_real_transcript_tensor(report):
    sc = report["scbd"]
    assert sc["ok"] and sc["tamper_rejected"]
    assert {k: sc[k] for k in REFERENCE_SCBD} == REFERENCE_SCBD


def test_report_schema_validates_and_serializes(report):
    validate_report(report)
    rt = json.loads(json.dumps(report))
    validate_report(rt)
    ref_validate_report(rt)              # the reference's schema contract
    assert report["ok"]


@pytest.mark.parametrize("mutate,msg", [
    (lambda r: r.update(schema="zkdl-audit-report/v0"), "schema"),
    (lambda r: r.pop("membership"), "missing key"),
    (lambda r: r["summary"].update(n_attacks=99), "n_attacks"),
    (lambda r: r["attacks"][0].update(rejected=False), "inconsistent"),
])
def test_schema_violations_raise(report, mutate, msg):
    bad = json.loads(json.dumps(report))
    mutate(bad)
    with pytest.raises(ValueError, match=msg):
        validate_report(bad)


# -- binding / audit byte formats (no proving) ------------------------------

def _synthetic_windows():
    rng = np.random.default_rng(5)
    return {w: [int(v) for v in rng.integers(1, 1 << 61, size=6,
                                             dtype=np.uint64)]
            for w in (0, 1, 3)}        # window ids need not be contiguous


def test_binding_bytes_roundtrip_and_reference_bytes():
    wcoms = _synthetic_windows()
    _, binding = mem.build_binding(wcoms)
    assert binding.to_bytes() == ref_mem.build_binding(wcoms)[1].to_bytes()
    rt = mem.DatasetBinding.from_bytes(binding.to_bytes())
    assert rt.hash_name == binding.hash_name
    assert rt.root == binding.root
    assert set(rt.windows) == {0, 1, 3}
    for w, span in binding.windows.items():
        assert (rt.windows[w].start, rt.windows[w].count,
                rt.windows[w].digest) == (span.start, span.count,
                                          span.digest)
    assert rt.n_samples == 18
    with pytest.raises(mem.AuditDecodeError):
        mem.DatasetBinding.from_bytes(binding.to_bytes()[:-1])
    with pytest.raises(mem.AuditDecodeError):
        mem.DatasetBinding.from_bytes(b"XXXX" + binding.to_bytes()[4:])


def test_dataset_level_audit_roundtrip_and_forgery_rejection():
    wcoms = _synthetic_windows()
    tree, binding = mem.build_binding(wcoms)
    members = [mem.com_to_bytes(c) for c in wcoms[1][:2]]
    rng = np.random.default_rng(77)
    outsiders = [mem.com_to_bytes(int(v))
                 for v in rng.integers(1, 1 << 61, size=2,
                                       dtype=np.uint64)]
    audit = mem.prove_membership(tree, binding, -1, members + outsiders)
    ref_tree, ref_binding = ref_mem.build_binding(wcoms)
    assert audit.to_bytes() == ref_mem.prove_membership(
        ref_tree, ref_binding, -1, members + outsiders).to_bytes()
    rt = mem.MembershipAudit.from_bytes(audit.to_bytes())
    assert rt.window == -1
    verdict = mem.verify_membership(binding, rt)
    assert verdict.ok
    assert [r.in_dataset for r in verdict.results] == [True, True,
                                                       False, False]
    assert all(r.in_window is None for r in verdict.results)

    # flipped answer: move a member to the excluded list
    forged = mem.MembershipAudit.from_bytes(audit.to_bytes())
    h = merkle.hash_bits(members[0], binding.hash_name)
    forged.proof.included.remove(h)
    forged.proof.excluded.append(h)
    assert not mem.verify_membership(binding, forged).ok

    # wrong root
    bad_root = mem.DatasetBinding(hash_name=binding.hash_name,
                                  root=b"\x00" * len(binding.root),
                                  windows=binding.windows)
    assert not mem.verify_membership(bad_root, rt).ok


def test_window_audit_requires_matching_proof_bytes():
    wcoms = _synthetic_windows()
    tree, binding = mem.build_binding(wcoms)
    audit = mem.prove_membership(tree, binding, 0,
                                 [mem.com_to_bytes(wcoms[0][0])])
    v = mem.verify_membership(binding, audit)      # no bytes presented
    assert not v.ok and "proof bytes" in v.reason
    v = mem.verify_membership(binding, audit, proof_bytes=b"garbage")
    assert not v.ok and "undecodable" in v.reason
    with pytest.raises(ValueError, match="not in binding"):
        mem.prove_membership(tree, binding, 7, [])
    with pytest.raises(TypeError, match="bytes"):
        mem.prove_membership(tree, binding, 0, [wcoms[0][0]])
