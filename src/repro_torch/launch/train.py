"""Training entry point of the port: the LM families and prove-while-train.

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 100 \
        --seq 512 --global-batch 8 [--ckpt-dir D --ckpt-every 20] \
        [--compress int8|topk] [--fail-at 37] [--resume] [--device cpu]
    python -m repro_torch.launch.train --arch qwen3-0.6b --layers 2 \
        --d-model 64 --device cpu --steps 4 --seq 32 --global-batch 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-0.6b --mesh 2x2 --device cpu ...

An LM family (dense, moe, ssm, hybrid, encdec, vlm) trains with AdamW
on the reference's synthetic token stream, with gradient compression,
periodic checkpoints, restart from the latest one after a failure
(``--fail-at`` injects one) and straggler monitoring: the reference's
`repro.launch.train` loop, with its flags and log lines.  Without
``--mesh`` it trains on one device with plain tensors.  ``--mesh DxM``
(``data`` x ``model``) or ``PxDxM`` (``pod`` x ...) trains on a
DeviceMesh: the state is DTensors placed by the sharding rules
(`repro_torch.distributed.sharding`), each global batch is sharded
over the batch axes, and a restart re-places the checkpoint under the
mesh it comes back on.  Under torchrun the world must have exactly the
mesh's ranks; outside it only ``1x1`` runs, in a world of one.  The
process group is NCCL on the card (one card per rank) and gloo with
``--device cpu``; rank 0 logs.

    python -m repro_torch.launch.train --arch fcnn-zkdl-16l \
        --layers 2 --d-model 8 --global-batch 4 --steps 8 \
        --prove-window 4 [--widths 16,8,4,2] [--no-verify] [--device cpu]
    python -m repro_torch.launch.train --arch dlrm-top-mlp-criteo1tb \
        --global-batch 512 --steps 1 --prove-window 1 --init fan-in \
        --lr-shift 16

A provable family proves while it trains: one aggregated proof per
``--prove-window`` steps over the family's layer graph, as the
reference's `run_zkdl_train`: weights and data are drawn from the same
seeded numpy stream in the same order, and that stream then feeds every
window's blinds, so the proofs are byte-identical to the reference's.
The shape table is ``--widths``, else the config's own ``widths``, else
``--layers`` x ``--d-model``.  The weights are U(-1,1) x 0.3, as the
reference's, or with ``--init fan-in`` U(-1,1) x 2/sqrt(fan-in), which
keeps the rescaled activations near 2^R at any width; the SGD step is
2^-``--lr-shift``.
With ``--proof-dir`` the crash-safe prover service
(`repro_torch.launch.serve.ProverService`) takes over: setup warms every
kernel with a throwaway window, training never blocks on proving, and
each window's proof streams to ``proof_NNNNNN.bin`` beside a serialized
``vk.bin``.  Everything runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch._device import resolve_device


def run_zkdl_train(cfg, args) -> int:
    from repro_torch.core import quantfc
    from repro_torch.core.pipeline import compile as zk_compile
    from repro_torch.launch import steps as steps_mod

    if args.widths:
        widths = tuple(int(w) for w in args.widths.split(","))
    elif cfg.widths:
        widths = cfg.widths
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
        rng.uniform(-1, 1, (widths[l], widths[l + 1]))
        * (2 / widths[l] ** 0.5 if args.init == "fan-in" else 0.3), qc)
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
    step_fn = steps_mod.build_zkdl_step(zk_cfg, lr_shift=args.lr_shift,
                                        device=dev)
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


MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(spec: str):
    """``DxM`` or ``PxDxM`` -> the shape tuple."""
    try:
        dims = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise SystemExit(f"bad --mesh {spec!r} (want DxM or PxDxM)")
    return dims


def start_mesh(spec: str, device=None):
    """(DeviceMesh of ``--mesh spec``, this rank's device, whether this
    call started the process group)."""
    from repro_torch.launch import mesh as mesh_mod

    dims = parse_mesh(spec)
    need = math.prod(dims)
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    started = not dist.is_initialized()
    if "WORLD_SIZE" in os.environ:                 # under torchrun
        world = int(os.environ["WORLD_SIZE"])
        if world != need:
            raise SystemExit(
                f"--mesh {spec} has {need} devices but torchrun started "
                f"{world} ranks: run it with --nproc-per-node {need}")
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise SystemExit(
                    f"--mesh {spec}: rank {local} has no card of its own "
                    f"({torch.cuda.device_count()} visible); NCCL takes one "
                    "card per rank, so run larger meshes on the CPU with "
                    "--device cpu")
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
        if started:
            dist.init_process_group(backend)       # env:// from torchrun
    elif need != 1:
        raise SystemExit(
            f"--mesh {spec} has {need} devices: run it under torchrun "
            f"--nproc-per-node {need} (outside torchrun the world is this "
            "one process)")
    else:
        mesh_mod.init_world(backend)
    return mesh_mod.make_mesh(dims, MESH_AXES[len(dims)]), dev, started


def build_state(cfg, opt_cfg, mesh=None, rng_seed: int = 0, device=None):
    """Fresh train state ``{"params", "opt"}`` on ``device`` (default: the
    card), drawn from a generator seeded with ``rng_seed``, and the
    state's shapes (`steps.state_specs`).  With a DeviceMesh the state
    is distributed by `steps.state_shardings` (every rank draws the same
    values)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer
    from repro_torch.train import optim

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rng_seed)
    params = transformer.init_params(cfg, gen)
    state = {"params": params, "opt": optim.init_opt_state(params, opt_cfg)}
    specs = steps_mod.state_specs(cfg, opt_cfg)
    if mesh is not None:
        state = steps_mod.place(state, steps_mod.state_shardings(
            cfg, mesh, specs))
    return state, specs


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _value(t) -> float:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return float(t)


def run_lm_train(cfg, args) -> int:
    from repro_torch.data import pipeline
    from repro_torch.distributed import hints
    from repro_torch.distributed import sharding as shard_rules
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.specs import train_batch_specs
    from repro_torch.train import compression, optim, resilience

    overrides = {}
    if args.layers:
        overrides["n_layers"] = args.layers
        if cfg.family == "encdec":
            overrides.update(enc_layers=args.layers, dec_layers=args.layers)
    if args.d_model:
        overrides["d_model"] = args.d_model
        overrides["head_dim"] = 0
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    mesh, started = None, False
    dev = resolve_device(args.device)
    if args.mesh is not None:
        mesh, dev, started = start_mesh(args.mesh, args.device)
        steps_mod.set_mesh_hints(mesh)
    rank0 = mesh is None or dist.get_rank() == 0

    def log(msg: str) -> None:
        if rank0:
            print(msg, flush=True)

    opt_cfg = steps_mod.default_opt_cfg(cfg)
    comp_cfg = compression.CompressionConfig(mode=args.compress)
    source = pipeline.make_source(cfg, args.seq, args.global_batch)
    where = f"mesh {args.mesh} {mesh.mesh_dim_names}" if mesh else str(dev)
    log(f"[train] {cfg.name} ({cfg.family}): {cfg.n_layers} layers x "
        f"{cfg.d_model}, {cfg.param_count() / 1e6:.1f}M params, seq "
        f"{args.seq}, batch {args.global_batch}, {cfg.dtype} on {where}")

    state, specs = build_state(cfg, opt_cfg, mesh, device=dev)
    residual = (compression.init_residuals(state["params"])
                if comp_cfg.mode != "none" else {})
    shardings = b_shard = None
    if mesh is not None:
        res_shard = shard_rules.param_shardings(cfg, mesh, residual)
        residual = steps_mod.place(residual, res_shard)
        shardings = dict(steps_mod.state_shardings(cfg, mesh, specs),
                         residual=res_shard)
        b_shard = shard_rules.batch_shardings(
            cfg, mesh, train_batch_specs(cfg, args.seq, args.global_batch))
    state["residual"] = residual

    def train_step(state, batch):
        on_mesh = (implicit_replication() if mesh is not None
                   else contextlib.nullcontext())
        with on_mesh:
            loss, grads = steps_mod.value_and_grad(cfg, state["params"],
                                                   batch)
            grads, new_res = compression.compress_grads(
                comp_cfg, grads, state["residual"])
            new_params, new_opt, metrics = optim.apply_updates(
                opt_cfg, state["params"], grads, state["opt"])
        metrics["loss"] = loss
        new_state = {"params": new_params, "opt": new_opt,
                     "residual": new_res}
        if mesh is not None:
            new_state = steps_mod.redistribute_to(new_state, shardings)
        return new_state, metrics

    policy = (resilience.CheckpointPolicy(args.ckpt_dir, args.ckpt_every)
              if args.ckpt_dir else None)
    injector = resilience.FailureInjector(args.fail_at)
    monitor = resilience.StragglerMonitor()
    metrics_out = (open(args.metrics_out, "a")
                   if args.metrics_out and rank0 else None)

    def loop(st, start):
        nonlocal state
        if st is not None:
            state = st
        step = start
        while step < args.steps:
            t0 = time.perf_counter()
            injector.check(step)
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in source.batch(step).items()}
            if mesh is not None:     # every rank made the same global batch
                batch = steps_mod.place(batch, b_shard)
            state, metrics = train_step(state, batch)
            loss = _value(metrics["loss"])
            dt = time.perf_counter() - t0
            monitor.observe(step, dt, lambda s, d: log(
                f"[train] straggler at step {s}: {d:.2f}s"))
            if step % args.log_every == 0:
                log(f"[train] step {step} loss {loss:.4f} {dt:.2f}s")
            rec = {"step": step, "loss": loss,
                   "grad_norm": _value(metrics["grad_norm"]),
                   "lr": _value(metrics["lr"]), "seconds": dt,
                   "tokens": args.global_batch * args.seq,
                   "state_bytes": steps_mod.local_bytes(state)}
            if policy:
                t1 = time.perf_counter()
                path = policy.maybe_save(step, state)
                if path:
                    rec["ckpt_seconds"] = time.perf_counter() - t1
                    rec["ckpt_bytes"] = _dir_bytes(path) if rank0 else 0
                    log(f"[train] checkpoint step {step}: "
                        f"{rec['ckpt_bytes'] / 1e6:.1f} MB in "
                        f"{rec['ckpt_seconds']:.2f}s")
            if metrics_out:
                metrics_out.write(json.dumps(rec) + "\n")
                metrics_out.flush()
            step += 1
        return state

    try:
        if policy:
            state = resilience.run_resilient(loop, state, policy,
                                             shardings=shardings, device=dev)
        else:
            state = loop(None, 0)
    finally:
        if metrics_out:
            metrics_out.close()
        if mesh is not None:
            hints.clear()
        if started:
            dist.destroy_process_group()
    log(f"[train] done: {args.steps} steps, "
        f"straggler events: {len(monitor.events)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM: train on a DeviceMesh with DTensors "
                         "(under torchrun, one rank per device; 1x1 alone "
                         "outside it); default: one device, plain tensors")
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layers (reduced runs)")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="resume from --ckpt-dir (with a --ckpt-dir the "
                         "run always starts from its latest checkpoint)")
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (drills restart)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None,
                    help="LM families: append one JSON line per step "
                         "(loss, grad norm, lr, seconds, checkpoint)")
    ap.add_argument("--prove", action="store_true",
                    help="require prove-while-train (families without a "
                         "registered proof graph fail loudly)")
    ap.add_argument("--prove-window", type=int, default=4,
                    help="steps per aggregated proof")
    ap.add_argument("--widths", default=None,
                    help="heterogeneous shape table d_0..d_L, e.g. "
                         "784,512,256,128,10")
    ap.add_argument("--init", default="fixed", choices=["fixed", "fan-in"],
                    help="provable families: weights U(-1,1) x 0.3 "
                         "(fixed) or x 2/sqrt(fan-in)")
    ap.add_argument("--lr-shift", type=int, default=8,
                    help="provable families: the SGD step is 2^-lr_shift")
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
    from repro_torch.core.pipeline.graph import (PROOF_GRAPH_BUILDERS,
                                                 proof_graph_for_family)
    try:
        arch_cfg = get_config(args.arch)
    except LookupError as exc:
        raise SystemExit(f"--arch: {exc}") from None
    if arch_cfg.family in PROOF_GRAPH_BUILDERS:
        return run_zkdl_train(arch_cfg, args)
    if args.prove:
        # raises "no proof graph registered for family ..." with the
        # list of provable families
        try:
            proof_graph_for_family(arch_cfg.family)
        except LookupError as exc:
            raise SystemExit(f"--prove: {exc}") from None
    return run_lm_train(arch_cfg, args)


if __name__ == "__main__":
    raise SystemExit(main())
