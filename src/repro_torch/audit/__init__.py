"""repro_torch.audit — the verifier-side counterpart to the prover pipeline,
the reference's `repro.audit` against the port's prover and verifier.

Three layers:

* ``attacks``    — a registry of structured adversaries over
  ``(witness trajectory, ProvingKey, proof bytes, vk)``, every one of
  which must be REJECTED by ``verify_bytes``;
* ``membership`` — the Section 4.4 data-membership audit revived onto
  the v3 proof format: bind per-step ``com_x`` sample commitments into
  a sparse-Merkle dataset root (``DatasetBinding``) and answer "were
  these committed samples used in window W" from bytes alone;
* ``report``     — ``python -m repro_torch.audit run``: the full battery
  against a freshly proved model, producing the audit report that gates
  on 100% rejection.

``membership.bind_service_dir`` waits for the port of the prover
service.
"""
from repro_torch.audit.attacks import (ATTACKS, AttackContext,
                                       AttackOutcome, build_context,
                                       run_attack, run_battery)
from repro_torch.audit.membership import (DatasetBinding, MembershipAudit,
                                          MembershipVerdict, QueryResult,
                                          WindowSpan, build_binding,
                                          com_to_bytes, commit_sample,
                                          prove_membership, sample_coms,
                                          verify_membership)
from repro_torch.audit.report import run_audit, validate_report

__all__ = [
    "ATTACKS", "AttackContext", "AttackOutcome", "build_context",
    "run_attack", "run_battery",
    "DatasetBinding", "MembershipAudit", "MembershipVerdict",
    "QueryResult", "WindowSpan", "build_binding",
    "com_to_bytes", "commit_sample", "prove_membership", "sample_coms",
    "verify_membership",
    "run_audit", "validate_report",
]
