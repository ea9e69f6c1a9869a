"""The audit battery runner: prove a fresh model, attack it, audit it.

``run_audit`` produces the ``AUDIT_report.json`` dict that CI gates on:
every registered attack REJECTED, the membership audit round-tripping
end-to-end from bytes (including through a fresh verifier process), and
the revived SC-BD sumcheck proving/verifying on its pinned transcript
domains.  ``validate_report`` is the schema contract tier-1 checks.

The report schema and every non-timing field are the reference's
(`repro.audit.report`); proving runs on ``device`` (default: the card),
and the fresh-process verifier is ``python -m repro_torch.audit
verify-membership`` with this package's source directory on its
``PYTHONPATH``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

REPORT_SCHEMA = "zkdl-audit-report/v1"

SCBD_TRANSCRIPT_LABEL = b"zkdl/scbd-audit"


def _child_env() -> dict:
    """The environment of a fresh verifier process: this one's, with the
    directory that holds ``repro_torch`` first on ``PYTHONPATH`` (a
    caller may have put it on ``sys.path`` only)."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _membership_section(ctx, work_dir: Optional[str],
                        fresh_process: bool) -> dict:
    """Bind two honest windows, query trained-on + held-out samples,
    verify from bytes in-process and (optionally) in a fresh process."""
    from repro_torch.audit import membership as mem
    from repro_torch.core.pipeline.proofio import VK_MAX_MERGED_LEN
    from repro_torch.core.pipeline.tables import rand_scalar

    t0 = time.perf_counter()
    raw0, raw1 = ctx.proof_bytes, ctx.second_window()
    coms0, coms1 = mem.sample_coms(raw0), mem.sample_coms(raw1)
    tree, binding = mem.build_binding({0: coms0, 1: coms1})

    # held-out samples: committed by the data owner exactly as the
    # prover would, but never part of any proved window
    rng = np.random.default_rng(ctx.seed + 4242)
    x_len = ctx.pk.keys.kx.n
    lim = 1 << (ctx.quant.q_bits - 1)
    held_out = [mem.com_to_bytes(mem.commit_sample(
        ctx.pk, rng.integers(-lim, lim, size=x_len), rand_scalar(rng)))
        for _ in range(3)]

    queried = ([mem.com_to_bytes(c) for c in coms0[:3]] +
               [mem.com_to_bytes(c) for c in coms1[:2]] +
               held_out)
    audit = mem.prove_membership(tree, binding, 0, queried)

    # byte round-trip BEFORE verification: the verifier side must work
    # from serialized artifacts alone
    binding_rt = mem.DatasetBinding.from_bytes(binding.to_bytes())
    audit_rt = mem.MembershipAudit.from_bytes(audit.to_bytes())
    verdict = mem.verify_membership(binding_rt, audit_rt,
                                    proof_bytes=raw0, vk=ctx.vk,
                                    label=ctx.label)

    want_dataset = [True] * 5 + [False] * 3
    want_window = [True] * 3 + [False] * 5
    got_dataset = [r.in_dataset for r in verdict.results]
    got_window = [bool(r.in_window) for r in verdict.results]
    ok = (verdict.ok and got_dataset == want_dataset and
          got_window == want_window)
    reason = verdict.reason if not verdict.ok else (
        "" if ok else "per-query membership answers wrong")

    section = {
        "ok": bool(ok),
        "reason": reason,
        "n_queried": len(queried),
        "n_members": verdict.n_members,
        "n_window_members": verdict.n_window_members,
        "n_non_members": len(queried) - verdict.n_members,
        "binding_bytes": len(binding.to_bytes()),
        "audit_bytes": len(audit.to_bytes()),
        "proof_nodes": audit.proof.size_nodes(),
        "cross_process": {"ran": False, "ok": None, "detail": ""},
    }

    if fresh_process and ok:
        d = work_dir or tempfile.mkdtemp(prefix="zkdl-audit-")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "vk.bin"), "wb") as f:
            f.write(ctx.vk.to_bytes())
        with open(os.path.join(d, "proof_000000.bin"), "wb") as f:
            f.write(raw0)
        with open(os.path.join(d, "dataset.bin"), "wb") as f:
            f.write(binding.to_bytes())
        with open(os.path.join(d, "audit_000000.bin"), "wb") as f:
            f.write(audit.to_bytes())
        if ctx.device.type == "cuda":
            # hand the cached blocks back: the child derives its own keys
            torch.cuda.empty_cache()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.audit", "verify-membership",
             "--dir", d, "--window", "0",
             "--label", ctx.label.decode(), "--device", ctx.device.type,
             "--max-merged-len",
             str(max(VK_MAX_MERGED_LEN, ctx.cfg.merged_len))],
            capture_output=True, text=True, env=_child_env())
        cp = {"ran": True, "ok": False, "detail": ""}
        try:
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            cp["ok"] = (proc.returncode == 0 and out["ok"] and
                        [r["in_dataset"] for r in out["results"]]
                        == want_dataset and
                        [r["in_window"] for r in out["results"]]
                        == want_window)
            if not cp["ok"]:
                cp["detail"] = f"rc={proc.returncode} out={out}"
        except (json.JSONDecodeError, KeyError, IndexError) as exc:
            cp["detail"] = (f"unparseable verifier output ({exc}): "
                            f"{proc.stdout[-400:]} {proc.stderr[-400:]}")
        section["cross_process"] = cp
        section["ok"] = bool(section["ok"] and cp["ok"])
    section["seconds"] = round(time.perf_counter() - t0, 3)
    return section


def _scbd_section(ctx, max_d: Optional[int] = None) -> dict:
    """Revived SC-BD range sumcheck over a REAL transcript tensor (the
    stacked gap aux; its first ``max_d`` entries when given, a power of
    two: the wiring tables grow as D^2), with the golden-digest
    canonical encoding and a forged-claim rejection check."""
    from repro_torch.core import scbd
    from repro_torch.core.pipeline.witness import stack_witnesses
    from repro_torch.core.transcript import Transcript

    t0 = time.perf_counter()
    cfg = ctx.cfg
    sw = stack_witnesses(ctx.wits, cfg)
    aux = sw.gap_s.reshape(-1)[:max_d]
    proof = scbd.prove(aux, cfg.q_bits, Transcript(SCBD_TRANSCRIPT_LABEL))
    ok = scbd.verify(proof, aux.shape[0], cfg.q_bits,
                     Transcript(SCBD_TRANSCRIPT_LABEL))
    forged = dataclasses.replace(proof, claim=proof.claim + 1)
    tamper_rejected = not scbd.verify(forged, aux.shape[0], cfg.q_bits,
                                      Transcript(SCBD_TRANSCRIPT_LABEL))
    return {
        "ok": bool(ok and tamper_rejected),
        "d": int(aux.shape[0]),
        "q_bits": int(cfg.q_bits),
        "digest": proof.digest(),
        "size_bytes": proof.size_bytes(),
        "tamper_rejected": bool(tamper_rejected),
        "seconds": round(time.perf_counter() - t0, 3),
    }


def run_audit(smoke: bool = False, widths=(4, 4, 4), batch: int = 2,
              n_steps: Optional[int] = None, q_bits: int = 16,
              r_bits: int = 4, seed: int = 11, label: bytes = b"zkdl",
              attack_names: Optional[List[str]] = None,
              work_dir: Optional[str] = None,
              fresh_process: bool = True, device=None) -> dict:
    """Prove a fresh model on ``device`` (default: the card), run the
    battery, the membership audit and SC-BD; returns the report dict."""
    from repro_torch.audit import attacks

    if n_steps is None:
        n_steps = 2 if smoke else 8
    t_start = time.perf_counter()
    ctx = attacks.build_context(widths=widths, batch=batch,
                                n_steps=n_steps, q_bits=q_bits,
                                r_bits=r_bits, seed=seed, label=label,
                                device=device)
    t0 = time.perf_counter()
    battery = attacks.run_battery(ctx, names=attack_names)
    battery_s = time.perf_counter() - t0

    membership = _membership_section(ctx, work_dir, fresh_process)
    scbd_sec = _scbd_section(ctx)

    families = sorted({o.family for o in battery})
    all_rejected = bool(battery) and all(o.rejected for o in battery)
    report = {
        "schema": REPORT_SCHEMA,
        "config": {"widths": list(widths), "batch": batch,
                   "n_steps": n_steps, "q_bits": q_bits,
                   "r_bits": r_bits, "seed": seed,
                   "label": label.decode(), "smoke": bool(smoke)},
        "timings": {"compile_s": round(ctx.compile_seconds, 3),
                    "prove_s": round(ctx.prove_seconds, 3),
                    "battery_s": round(battery_s, 3),
                    "total_s": round(time.perf_counter() - t_start, 3)},
        "attacks": [o.as_dict() for o in battery],
        "summary": {"n_attacks": len(battery),
                    "n_rejected": sum(o.rejected for o in battery),
                    "n_accepted": sum(not o.rejected for o in battery),
                    "families": families,
                    "all_rejected": all_rejected},
        "membership": membership,
        "scbd": scbd_sec,
        "ok": bool(all_rejected and membership["ok"] and scbd_sec["ok"]),
    }
    validate_report(report)
    return report


def validate_report(report: dict) -> None:
    """Schema contract for AUDIT_report.json (raises ValueError)."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"audit report schema: {msg}")

    need(isinstance(report, dict), "not a dict")
    need(report.get("schema") == REPORT_SCHEMA,
         f"schema != {REPORT_SCHEMA}")
    for key in ("config", "timings", "attacks", "summary", "membership",
                "scbd", "ok"):
        need(key in report, f"missing key {key!r}")
    need(isinstance(report["attacks"], list) and report["attacks"],
         "empty attack list")
    for o in report["attacks"]:
        for key in ("name", "family", "rejected", "seconds", "variants"):
            need(key in o, f"attack missing {key!r}")
        need(isinstance(o["variants"], list) and o["variants"],
             f"attack {o.get('name')} has no variants")
        need(o["rejected"] == all(v["rejected"] for v in o["variants"]),
             f"attack {o['name']} rejected-bit inconsistent")
    s = report["summary"]
    need(s["n_attacks"] == len(report["attacks"]), "n_attacks mismatch")
    need(s["n_rejected"] + s["n_accepted"] == s["n_attacks"],
         "rejected/accepted split mismatch")
    need(s["all_rejected"] == (s["n_accepted"] == 0 and s["n_attacks"] > 0),
         "all_rejected inconsistent")
    need(set(s["families"]) ==
         {o["family"] for o in report["attacks"]}, "families mismatch")
    m = report["membership"]
    for key in ("ok", "reason", "n_queried", "n_members",
                "n_window_members", "n_non_members", "cross_process"):
        need(key in m, f"membership missing {key!r}")
    need(m["n_members"] + m["n_non_members"] == m["n_queried"],
         "membership counts mismatch")
    for key in ("ok", "d", "q_bits", "digest", "tamper_rejected"):
        need(key in report["scbd"], f"scbd missing {key!r}")
    need(report["ok"] == (s["all_rejected"] and m["ok"] and
                          report["scbd"]["ok"]),
         "top-level ok inconsistent with sections")
