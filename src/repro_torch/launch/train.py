"""Prove-while-train entry point for provable integer-SGD families.

    python -m repro_torch.launch.train --arch fcnn-zkdl-16l \
        --layers 2 --d-model 8 --global-batch 4 --steps 8 \
        --prove-window 4 [--widths 16,8,4,2] [--no-verify] [--device cpu]

One aggregated proof per ``--prove-window`` steps over the family's
layer graph, as the reference's `repro.launch.train.run_zkdl_train`:
weights and data are drawn from the same seeded numpy stream in the same
order, and that stream then feeds every window's blinds, so the proofs
are byte-identical to the reference's.  Without overrides this is the
paper-scale 16 x 4096 network.  Runs on the card unless ``--device cpu``.

With ``--proof-dir`` the crash-safe prover service
(`repro_torch.launch.serve.ProverService`) takes over, as in the
reference: setup warms every kernel with a throwaway window, training
never blocks on proving (each step witness is journaled and queued),
and each window's proof streams to ``proof_NNNNNN.bin`` beside a
serialized ``vk.bin``.  The reference's other model families are not
ported yet (ROADMAP.md queue 1, item 16).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device


def run_zkdl_train(cfg, args) -> int:
    from repro_torch.core import quantfc
    from repro_torch.core.pipeline import compile as zk_compile
    from repro_torch.launch import steps as steps_mod

    if args.widths:
        widths = tuple(int(w) for w in args.widths.split(","))
    else:
        layers = args.layers or cfg.n_layers
        width = args.d_model or cfg.d_model
        widths = (width,) * (layers + 1)
    dev = resolve_device(args.device)
    window = max(1, args.prove_window)
    zk_cfg = steps_mod.build_proof_pipeline_config(
        cfg, batch=args.global_batch, n_steps=window, widths=widths)
    qc = quantfc.QuantConfig(q_bits=zk_cfg.q_bits, r_bits=zk_cfg.r_bits)
    shape = ("x".join(str(w) for w in widths) if len(set(widths)) > 1
             else f"{zk_cfg.n_layers} layers x {widths[0]} wide")
    print(f"[train] zkdl {cfg.family}: {shape}, batch {args.global_batch}, "
          f"aggregating {window} step(s)/proof on {dev}", flush=True)

    service = None
    if args.proof_dir:
        from repro_torch.launch.serve import ProverService
        service = ProverService(zk_cfg.graph, qc, n_steps=zk_cfg.n_steps,
                                out_dir=args.proof_dir,
                                verify=not args.no_verify, device=dev)
        service.start(warm=True)
        pk = service.pk
        print(f"[train] prover service warm in {service.warm_seconds:.1f}s "
              f"(kernel build cache: {service.warm_stats}); streaming "
              f"proofs to {args.proof_dir}", flush=True)
    else:
        pk, _ = zk_compile(zk_cfg.graph, qc, n_steps=zk_cfg.n_steps,
                           device=dev)
    rng = np.random.default_rng(0)
    ws = [quantfc.quantize(
        rng.uniform(-1, 1, (widths[l], widths[l + 1])) * 0.3, qc)
        for l in range(zk_cfg.n_layers)]
    ws = [torch.as_tensor(w, device=dev) for w in ws]
    data_x = rng.uniform(-1, 1, (args.global_batch * 8, widths[0]))
    data_y = rng.uniform(-1, 1, (args.global_batch * 8, widths[-1]))

    def on_proof(step, proof, dt):
        print(f"[train] step {step}: aggregated proof over "
              f"{proof.n_steps} steps, {proof.size_bytes() / 1024:.1f} kB "
              f"in {dt:.1f}s ({dt / proof.n_steps:.1f}s/step, "
              f"verified={not args.no_verify})", flush=True)

    hook = None
    if service is None:
        hook = steps_mod.ZkdlProveHook(pk, rng, verify=not args.no_verify,
                                       on_proof=on_proof)
    step_fn = steps_mod.build_zkdl_step(zk_cfg, device=dev)
    for step in range(args.steps):
        lo = (step * args.global_batch) % data_x.shape[0]
        batch = {
            "x": quantfc.quantize(data_x[lo:lo + args.global_batch], qc),
            "y": quantfc.quantize(data_y[lo:lo + args.global_batch], qc),
        }
        t0 = time.perf_counter()
        ws, wit = step_fn(ws, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t0          # training only
        if service is not None:
            service.submit(wit)                    # journaled, non-blocking
        else:
            hook.observe(step, wit)                # logged per window
        if step % args.log_every == 0:
            print(f"[train] step {step} {step_s:.2f}s", flush=True)
    if service is not None:
        service.close()
        for window, path, n_bytes, secs in service.proofs:
            print(f"[train] window {window}: {n_bytes} B -> {path} "
                  f"({secs:.2f}s, verified={not args.no_verify})",
                  flush=True)
        n_proofs, pending = service.n_proofs, args.steps % window
    else:
        n_proofs, pending = len(hook.proofs), hook.n_pending
    print(f"[train] done: {args.steps} steps, {n_proofs} "
          f"aggregated proofs, {pending} step(s) pending "
          f"(next window)", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layers (reduced runs)")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--prove-window", type=int, default=4,
                    help="steps per aggregated proof")
    ap.add_argument("--widths", default=None,
                    help="heterogeneous shape table d_0..d_L, e.g. "
                         "784,512,256,128,10")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip verifying emitted proofs")
    ap.add_argument("--proof-dir", default=None,
                    help="run the crash-safe prover service and stream "
                         "proof_NNNNNN.bin + vk.bin into this directory "
                         "(training never blocks)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.core.pipeline.graph import PROOF_GRAPH_BUILDERS
    try:
        arch_cfg = get_config(args.arch)
    except LookupError as exc:
        raise SystemExit(f"--arch: {exc}") from None
    if arch_cfg.family not in PROOF_GRAPH_BUILDERS:
        raise SystemExit(f"--arch {args.arch}: family {arch_cfg.family!r} "
                         "has no proof graph; its model steps are not "
                         "ported (ROADMAP.md queue 1, item 16)")
    return run_zkdl_train(arch_cfg, args)


if __name__ == "__main__":
    raise SystemExit(main())
