"""CLI: ``python -m repro_torch.audit run [--smoke]`` and the fresh-process
membership verifier ``python -m repro_torch.audit verify-membership``.

``run`` proves a fresh model, fires the full adversarial battery, runs
the membership + SC-BD audits and writes the report (by default
``build/AUDIT_report.json`` at the repository root; the repository's
own ``AUDIT_report.json`` is the reference's record); exit
status is nonzero unless EVERY attack was rejected and both audits
passed — the CI gate is the process exit code, the report is the
evidence.

``verify-membership`` is deliberately minimal: it loads only serialized
artifacts (``vk.bin``, ``dataset.bin``, ``proof_*.bin``, ``audit_*.bin``)
and prints a JSON verdict — the deployment-shaped data-owner side.

Both take the reference's flags plus ``--device`` (default: the card;
``cpu`` runs the plain versions of the kernels); ``verify-membership``
also takes ``--max-merged-len``, since a full-width ``vk.bin`` asks for
a larger key than the decoder derives by default.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_run(args) -> int:
    from repro_torch.audit.report import run_audit

    report = run_audit(smoke=args.smoke,
                       n_steps=args.steps,
                       seed=args.seed,
                       label=args.label.encode(),
                       attack_names=(args.attacks.split(",")
                                     if args.attacks else None),
                       work_dir=args.dir,
                       fresh_process=not args.no_fresh_process,
                       device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    s = report["summary"]
    for o in report["attacks"]:
        status = "REJECTED" if o["rejected"] else "ACCEPTED *** FORGERY ***"
        print(f"audit: {o['name']:<28s} [{o['family']}] {status} "
              f"({o['seconds']:.2f}s)")
    m = report["membership"]
    cp = m["cross_process"]
    print(f"audit: membership {'ok' if m['ok'] else 'FAILED'} "
          f"({m['n_members']}/{m['n_queried']} members, "
          f"{m['n_window_members']} in window, fresh-process="
          f"{cp['ok'] if cp['ran'] else 'skipped'})")
    print(f"audit: scbd {'ok' if report['scbd']['ok'] else 'FAILED'} "
          f"(d={report['scbd']['d']}, "
          f"digest={report['scbd']['digest'][:16]}...)")
    print(f"audit: {s['n_rejected']}/{s['n_attacks']} attacks rejected "
          f"across {len(s['families'])} families -> "
          f"{'OK' if report['ok'] else 'FAILED'} "
          f"({report['timings']['total_s']:.1f}s, report: {args.out})")
    return 0 if report["ok"] else 1


def _cmd_verify_membership(args) -> int:
    from repro_torch.audit.membership import (DatasetBinding, MembershipAudit,
                                              verify_membership)
    from repro_torch.core.pipeline.proofio import decode_vk

    d = args.dir
    with open(os.path.join(d, "vk.bin"), "rb") as f:
        vk = decode_vk(f.read(), max_merged_len=args.max_merged_len,
                       device=args.device)
    with open(os.path.join(d, "dataset.bin"), "rb") as f:
        binding = DatasetBinding.from_bytes(f.read())
    with open(os.path.join(d, f"audit_{args.window:06d}.bin"), "rb") as f:
        audit = MembershipAudit.from_bytes(f.read())
    proof_bytes = None
    if audit.window >= 0:
        with open(os.path.join(d, f"proof_{args.window:06d}.bin"),
                  "rb") as f:
            proof_bytes = f.read()
    verdict = verify_membership(binding, audit, proof_bytes=proof_bytes,
                                vk=vk, label=args.label.encode())
    print(json.dumps({
        "ok": verdict.ok,
        "reason": verdict.reason,
        "window": audit.window,
        "n_queried": len(audit.queried),
        "results": [{"com": r.com.hex(), "in_dataset": r.in_dataset,
                     "in_window": r.in_window}
                    for r in verdict.results],
    }))
    return 0 if verdict.ok else 1


def main(argv=None) -> int:
    from repro_torch.core.pipeline.proofio import VK_MAX_MERGED_LEN
    from repro_torch.kernels._build import REPO_ROOT

    p = argparse.ArgumentParser(prog="python -m repro_torch.audit")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="full adversarial battery + audits")
    runp.add_argument("--smoke", action="store_true",
                      help="T=2 window (CI); default is the T=8 window")
    runp.add_argument("--steps", type=int, default=None,
                      help="override the aggregation window length")
    runp.add_argument("--seed", type=int, default=11)
    runp.add_argument("--label", default="zkdl")
    runp.add_argument("--out", default=str(REPO_ROOT / "build" /
                                           "AUDIT_report.json"))
    runp.add_argument("--dir", default=None,
                      help="artifact dir for the fresh-process membership "
                           "round-trip (default: a temp dir)")
    runp.add_argument("--attacks", default=None,
                      help="comma-separated subset of attack names")
    runp.add_argument("--no-fresh-process", action="store_true")
    runp.add_argument("--device", default=None,
                      help="cuda (default) or cpu")
    runp.set_defaults(fn=_cmd_run)

    vm = sub.add_parser("verify-membership",
                        help="data-owner verifier: bytes in, verdict out")
    vm.add_argument("--dir", required=True)
    vm.add_argument("--window", type=int, required=True)
    vm.add_argument("--label", default="zkdl")
    vm.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    vm.add_argument("--max-merged-len", type=int, default=VK_MAX_MERGED_LEN,
                    help="largest merged key vk.bin may ask to derive "
                         "(the decoder's guard against oversized keys; "
                         "raise it for a vk.bin you trust)")
    vm.set_defaults(fn=_cmd_verify_membership)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
