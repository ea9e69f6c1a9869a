"""Tier-1 harness for every test under this root, kept apart from the
test files: one host device for every in-process test, the reference's
executable disk cache off where subprocesses force another device count,
and the `slow` list of reference tests that tier-1 skips.

Two modules prepend --xla_force_host_platform_device_count=512 to
XLA_FLAGS when imported: src/repro/launch/dryrun.py (imported at
collection by tests/test_roofline.py) and benchmarks/perf.py (imported
by tests/test_bench_imports.py).  JAX reads the flag once, when its
backend starts, so the backend is started here, before collection."""
import importlib.util
import os

import pytest

# Tests that tier-1 skips and `pytest -m slow` runs: each spends over 60 s
# in the frozen reference (its XLA CPU compiles, or a subprocess that runs
# it) when run alone.  Node id -> (its seconds alone, one process at a
# time, on an 8-core CPU with fresh REPRO_JAX_CACHE, ZKDL_EXEC_CACHE, HOME
# and TMPDIR, ">61" if still running when cut 61 s after it started; the
# reference function its stack showed at 58-61 s).  Port tests never go
# here: make them fast instead.
SLOW = {
    "tests/test_agg_opening.py::test_cross_slot_claim_swap_rejects":
        (">61", "zkrelu.prove_statements"),
    "tests/test_audit.py::test_every_attack_rejected":
        (">61", "zkrelu.prove_statements"),
    "tests/test_audit.py::test_battery_covers_required_attack_classes":
        (">61", "zkrelu.prove_statements"),
    "tests/test_audit.py::test_membership_roundtrip_from_bytes":
        (">61", "zkrelu.prove_statements"),
    "tests/test_audit.py::test_scbd_revived_on_real_transcript_tensor":
        (">61", "mle.fdot_many"),
    "tests/test_audit.py::test_report_schema_validates_and_serializes":
        (">61", "modarith._cond_sub_mod"),
    "tests/test_audit.py::test_schema_violations_raise[<lambda>-schema]":
        (">61", "openings._combine_claims"),
    "tests/test_audit.py::test_schema_violations_raise[<lambda>-missing key]":
        (">61", "zkrelu.prove_statements"),
    "tests/test_audit.py::test_schema_violations_raise[<lambda>-n_attacks]":
        (">61", "mle.expand_point"),
    "tests/test_audit.py::test_schema_violations_raise[<lambda>-inconsistent]":
        (">61", "zkrelu.prove_statements"),
    "tests/test_exec_cache.py::test_cross_process_warm_start":
        (">61", "two subprocesses proving with the reference"),
    "tests/test_field.py::test_batch_inv[Fq]":
        (">61", "modarith.batch_inv, jitted by the test"),
    "tests/test_field.py::test_batch_inv[Fp]":
        (">61", "modarith.batch_inv, jitted by the test"),
    "tests/test_gateway_chaos.py::test_two_tenants_commit_exactly_once_and_verify":
        (">61", "anchor.prove"),
    "tests/test_gateway_chaos.py::test_worker_death_reclaims_job_and_respawns":
        (">61", "sumcheck.sumcheck_prove"),
    "tests/test_gateway_chaos.py::test_job_that_kills_every_worker_fails_terminally":
        (">61", "tables.kron_many"),
    "tests/test_gateway_chaos.py::test_journal_enospc_drop_window_policy":
        (">61", "ops.build_tables"),
    "tests/test_gateway_chaos.py::test_journal_enospc_block_policy_retries_with_backoff":
        (">61", "zkrelu.prove_statements"),
    "tests/test_gateway_chaos.py::test_journal_enospc_block_policy_exhausted_raises_typed":
        (">61", "zkrelu.prove_statements"),
    "tests/test_gateway_chaos.py::test_proof_write_enospc_fails_window_keeps_journal":
        (">61", "openings._combine_claims"),
    "tests/test_gateway_chaos.py::test_manifest_enospc_never_gcs_ahead_of_commit_line":
        (">61", "mle.expand_point"),
    "tests/test_gateway_chaos.py::test_breaker_trips_parks_then_half_open_recovers":
        (">61", "openings._combine_claims"),
    "tests/test_gateway_chaos.py::test_preflight_rejects_before_journal":
        (">61", "openings.prover_blocks"),
    "tests/test_gateway_chaos.py::test_gateway_restart_resumes_every_tenant":
        (">61", "openings.prove"),
    "tests/test_ipa.py::test_pair_roundtrip[32]":
        (">61", "ipa._pair_rounds_ladder"),
    "tests/test_ipa.py::test_pair_prove_many_accel_matches_explicit":
        (">61", "ipa._pair_rounds_ladder"),
    "tests/test_proof_session.py::test_aggregated_roundtrip_accepts":
        (">61", "openings._combine_claims"),
    "tests/test_proof_session.py::test_rejects_flipped_aux_bit":
        (">61", "zkrelu.prove_statements"),
    "tests/test_proof_session.py::test_rejects_tampered_step1_gradient":
        (">61", "openings._combine_claims"),
    "tests/test_proof_session.py::test_rejects_step_count_tamper":
        (">61", "zkrelu.prove_statements"),
    "tests/test_proof_session.py::test_rejects_stale_transcript":
        (">61", "zkrelu.prove_statements"),
    "tests/test_proof_session.py::test_rejects_cross_step_claim_swap":
        (">61", "openings._combine_claims"),
    "tests/test_proof_session.py::test_rejects_tampered_opening":
        (">61", "openings._combine_claims"),
    "tests/test_proof_session.py::test_heterogeneous_pyramid_roundtrip":
        (">61", "tables.fix_rows"),
    "tests/test_proof_session.py::test_heterogeneous_rejects_tampered_witness":
        (">61", "tables.fix_rows"),
    "tests/test_proof_session.py::test_heterogeneous_rejects_claim_split_tamper":
        (">61", "tables.fix_cols"),
    "tests/test_proof_session.py::test_non_pow2_widths_roundtrip":
        (">61", "modarith.decode"),
    "tests/test_proof_session.py::test_uniform_graph_transcript_pinned[1]":
        (">61", "modarith.mont_mul"),
    "tests/test_proof_session.py::test_uniform_graph_transcript_pinned[2]":
        (">61", "tables.kron_many"),
    "tests/test_proof_session.py::test_v3_bytes_invariant_to_compile_path[jnp]":
        (">61", "modarith._cond_sub_mod"),
    "tests/test_proof_session.py::test_v3_bytes_invariant_to_compile_path[pallas]":
        (">61", "modarith.decode"),
    "tests/test_proof_session.py::test_prover_phase_profile_accounts_for_total":
        (">61", "sumcheck.sumcheck_prove"),
    "tests/test_proofio.py::test_golden_serialized_bytes[1]":
        (">61", "sumcheck.sumcheck_prove"),
    "tests/test_proofio.py::test_golden_serialized_bytes[2]":
        (">61", "sumcheck.sumcheck_prove"),
    "tests/test_proofio.py::test_roundtrip_identity":
        (">61", "sumcheck.sumcheck_prove"),
    "tests/test_proofio.py::test_tamper_each_section_rejects":
        (">61", "sumcheck.sumcheck_prove"),
    "tests/test_proofio.py::test_malformed_streams_reject":
        (">61", "mle.fdot_many"),
    "tests/test_proofio.py::test_version_negotiation_rejects_v1_with_migration_hint":
        (">61", "openings.prover_blocks"),
    "tests/test_proofio.py::test_single_ipa_section_tamper_rejects":
        (">61", "zkrelu.prove_statements"),
    "tests/test_proofio.py::test_renamed_slot_rejects_without_crash":
        (">61", "zkrelu.prove_statements"),
    "tests/test_proofio.py::test_vk_roundtrip":
        (">61", "openings.prover_blocks"),
    "tests/test_proofio.py::test_residual_mlp_cross_process_verify":
        (">61", "sumcheck.sumcheck_prove"),
    "tests/test_proofio_fuzz.py::test_proof_decode_fuzz_never_crashes":
        (">61", "zkrelu.prove_statements"),
    "tests/test_proofio_fuzz.py::test_vk_decode_fuzz_never_crashes":
        (">61", "zkrelu.prove_statements"),
    "tests/test_proofio_fuzz.py::test_mutated_proofs_verify_reject_cleanly":
        (">61", "zkrelu.prove_statements"),
    "tests/test_proofio_fuzz.py::test_mutated_vks_verify_cleanly_without_crash":
        (">61", "sumcheck.sumcheck_prove"),
    "tests/test_scbd.py::test_scbd_roundtrip[64-16]":
        (">61", "modarith.decode"),
    "tests/test_scbd.py::test_scbd_roundtrip[256-16]":
        (">61", "modarith.decode"),
    "tests/test_serve_chaos.py::test_crash_then_restart_commits_every_window_once[submit/journal-pre@2]":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_crash_then_restart_commits_every_window_once[submit/journal-post@3]":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_crash_then_restart_commits_every_window_once[prove/mid@1]":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_crash_then_restart_commits_every_window_once[commit/pre-manifest@0]":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_crash_then_restart_commits_every_window_once[worker/kill@1]":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_crash_then_restart_commits_every_window_once[prove/mid@1:corrupt-cache]":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_exhausted_retries_mark_failed_and_keep_going":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_backpressure_drop_window_accounting":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_close_handles_dead_worker_without_hanging":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_partial_trailing_window_reported_not_discarded":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_corrupt_journal_segment_fails_window_not_service":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_close_is_idempotent_and_submit_after_close_raises":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_service_journal_enospc_block_retries_then_drop_drops":
        (">61", "zkrelu.prove_statements"),
    "tests/test_serve_chaos.py::test_subprocess_isolation_survives_signal_death":
        (">61", "zkrelu.prove_statements"),
    "tests/test_zkdl.py::test_prove_verify_accepts":
        (">61", "openings._combine_claims"),
    "tests/test_zkdl.py::test_rejects_tampered_gradient":
        (">61", "openings._combine_claims"),
    "tests/test_zkdl.py::test_rejects_tampered_relu_mask":
        (">61", "mle.expand_point"),
    "tests/test_zkdl.py::test_rejects_tampered_forward":
        (">61", "mle.expand_point"),
    "tests/test_zkdl.py::test_rejects_proof_reuse_other_witness":
        (">61", "modarith.decode"),
    "tests/test_zkrelu.py::test_validity_accepts_honest":
        (">61", "zkrelu.prove_statements"),
    "tests/test_zkrelu.py::test_validity_rejects_bitflip":
        (">61", "zkrelu.prove_statements"),
    "tests/test_zkrelu.py::test_validity_rejects_witness_value_flip":
        (">61", "zkrelu.prove_statements"),
    "tests/test_zkrelu.py::test_validity_rejects_wrong_claim":
        (">61", "zkrelu.prove_statements"),
    "tests/test_zkrelu.py::test_cross_statement_swap_rejects":
        (">61", "zkrelu.prove_statements"),
}

# Test files whose subprocesses force a host device count (4 and 8): they
# run with the reference's executable disk cache off, because
# `repro.core.execache` keys its entries without the device count and an
# entry written at one count fails to load at another.
FORCED_HOST_DEVICES = {"tests/test_moe_parity.py", "tests/test_elastic_restart.py"}

# The reference runs on the CPU only, never on a card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_SESSION_XLA_FLAGS = os.environ.get("XLA_FLAGS")


def pytest_configure(config):
    # Start JAX's CPU backend before collection imports a module that
    # forces 512 host devices, so this process keeps one.  No backend is
    # started where JAX is absent (the card's machine) or was pointed at
    # another platform.
    if (os.environ["JAX_PLATFORMS"] == "cpu"
            and importlib.util.find_spec("jax") is not None):
        import jax
        jax.devices()


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    run_slow = "slow" in (config.getoption("markexpr") or "")
    for item in items:
        entry = SLOW.get(item.nodeid)
        if entry is None:
            continue
        item.add_marker(pytest.mark.slow)
        if not run_slow:
            seconds, where = entry
            item.add_marker(pytest.mark.skip(
                reason=f"slow: {seconds} s alone in the reference "
                       f"({where}); run with -m slow"))


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    # Collection, or an earlier test, may have imported a module that
    # rewrites XLA_FLAGS; the subprocesses a test starts inherit the
    # session's flags instead.
    if _SESSION_XLA_FLAGS is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = _SESSION_XLA_FLAGS


@pytest.fixture(autouse=True)
def _no_disk_executables_at_other_device_counts(request, monkeypatch):
    if request.node.nodeid.split("::")[0] in FORCED_HOST_DEVICES:
        monkeypatch.setenv("ZKDL_EXEC_CACHE", "off")
