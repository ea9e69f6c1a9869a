"""Prove-while-train at a configuration of mixed widths: the path, the
windows, the checks and the record of `train_prove_verify`, for a
configuration that lists its shape table d_0..d_L under ``widths``.

What the widths change: each layer's weights are drawn with its own
fan-in, U(-1,1) x weight_gain / sqrt(d_{l-1}); x ~ U(-1,1) x data_gain;
the labels are 0/1 clicks at scale 2^R, each 1 with probability
``label_share``; and each layer's weight fingerprint probes it at its
own shape.  Everything else is `train_prove_verify`'s: the set-up, the
timed window of whole aggregation windows, each restarting from the
checkpoint (the seed's weights) on a batch no earlier window used, the
reference's replay of every step after the window, and the five checks
with the limit 0.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from zkbench import tracing
from zkbench.drivers.train_prove_verify import (F64, LABEL, _sync,
                                                flip_ipa_byte, quantize)
from zkbench.reference import proofcheck, sgd
from zkbench.work.geometry import Geometry


def geometry(config: dict, cell: dict) -> Geometry:
    return Geometry(tuple(config["widths"]), config["batch"],
                    cell["window_steps"], config["q_bits"], config["r_bits"])


def make_inputs(config: dict, cell: dict, seed: int, dev) -> dict:
    """Everything both sides are handed, drawn on ``dev`` from the seed:
    the weights layer by layer, a pool of distinct batches (kept on the
    host as int16) and, per layer, the integer probe vectors of its
    weight fingerprint."""
    d, B = config["widths"], config["batch"]
    q, r = config["q_bits"], config["r_bits"]
    P = cell["batch_pool"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 63))
    ws = [quantize(torch.rand((d[l], d[l + 1]), generator=gen, device=dev,
                              dtype=F64),
                   cell["weight_gain"] / math.sqrt(d[l]), q, r)
          for l in range(len(d) - 1)]
    x = quantize(torch.rand((P, B, d[0]), generator=gen, device=dev,
                            dtype=F64), cell["data_gain"], q, r)
    y = (torch.rand((P, B, d[-1]), generator=gen, device=dev, dtype=F64)
         < cell["label_share"]).to(torch.int64) << r
    probes = [(torch.randint(1, 16, (2, d[l]), generator=gen, device=dev),
               torch.randint(1, 16, (2, d[l + 1]), generator=gen, device=dev))
              for l in range(len(d) - 1)]
    return {"ws": ws, "pool_x": x.to(torch.int16).cpu(),
            "pool_y": y.to(torch.int16).cpu(),
            "probes": [(u.to(F64), v.to(F64)) for u, v in probes]}


def batch(inputs: dict, k: int, dev) -> tuple:
    i = k % inputs["pool_x"].shape[0]
    return inputs["pool_x"][i].to(dev), inputs["pool_y"][i].to(dev)


def fingerprint(ws: List[torch.Tensor], probes: list) -> torch.Tensor:
    """Two exact integer bilinear forms u^T W v per layer, u and v of
    the layer's own in- and out-width (entries in [1, 15]; every partial
    sum below 2^53), so any one changed weight changes them."""
    return torch.stack([u[i] @ (w.to(F64) @ v[i])
                        for w, (u, v) in zip(ws, probes) for i in (0, 1)])


def replay(inputs: dict, params: dict, n_steps: int, dev,
           matmul=sgd.exact_matmul, step=sgd.sgd_step):
    """The reference's trajectory from the same inputs: per step the
    fingerprint and the committed tensors (a generator), then the final
    weights."""
    probes = [(u.to(dev), v.to(dev)) for u, v in inputs["probes"]]
    for k in range(n_steps):
        if k % params["window_steps"] == 0:
            ws = [w.to(dev) for w in inputs["ws"]]
        x, y = batch(inputs, k, dev)
        ws, tensors = step(ws, x, y, params["q_bits"], params["r_bits"],
                           params["lr_shift"], matmul)
        yield fingerprint(ws, probes).cpu(), tensors
    yield [w.cpu() for w in ws], None


def judge(inputs: dict, produced: dict, geo: Geometry, params: dict,
          dev, matmul=sgd.exact_matmul) -> dict:
    """`train_prove_verify.judge` over this driver's inputs: the five
    numbers compared, each with its limit, and the windows that
    failed."""
    fps, raws = produced["fps"], produced["raws"]
    T = geo.n_steps
    off_fp = off_open = 0
    bad_windows = set()
    window: list = []
    run = replay(inputs, params, len(fps), dev, matmul)
    for k in range(len(fps)):
        fp, tensors = next(run)
        n = int((fp != fps[k]).sum())
        off_fp += n
        window.append(tensors)
        if n:
            bad_windows.add(k // T)
        if len(window) == T:
            w_i = k // T
            bad = (proofcheck.check_proof(raws[w_i], geo, window, LABEL)
                   if w_i < len(raws) else ["missing"])
            off_open += len(bad)
            if bad:
                bad_windows.add(w_i)
            window = []
    final_ref, _ = next(run)
    off_final = sum(int((a != b).sum())
                    for a, b in zip(final_ref, produced["final_ws"]))
    rejected = [i for i, ok in enumerate(produced["accepted"]) if not ok]
    bad_windows.update(rejected)
    checks = {"step_weights_off": (off_fp, 0),
              "final_weights_off": (off_final, 0),
              "openings_off": (off_open, 0),
              "honest_rejected": (len(rejected), 0),
              "tampered_accepted": (int(bool(produced["tampered_accepted"])),
                                    0)}
    return {"checks": checks, "bad_windows": bad_windows}


def run(ctx) -> dict:
    from repro_torch.core.pipeline import api, build_fcnn_graph
    from repro_torch.core.pipeline import proofio, verifier
    from repro_torch.core.quantfc import QuantConfig
    from repro_torch.launch import steps

    dev = torch.device(ctx.device)
    config, cell = ctx.config, ctx.cell
    geo = geometry(config, cell)
    T = geo.n_steps
    params = {"q_bits": geo.q_bits, "r_bits": geo.r_bits,
              "lr_shift": cell["lr_shift"], "window_steps": T}

    # -- set-up -----------------------------------------------------------
    pk, vk = api.compile(build_fcnn_graph(geo.widths, geo.batch),
                         QuantConfig(geo.q_bits, geo.r_bits), n_steps=T,
                         device=dev)
    vkey = proofio.decode_vk(vk.to_bytes(), max_merged_len=geo.merged_len,
                             device=dev)
    vkey.keys                            # a deployed verifier's generators
    del vk
    inputs = make_inputs(config, cell, ctx.seed, dev)
    checkpoint = inputs["ws"]
    inputs["ws"] = [w.cpu() for w in checkpoint]
    probes = inputs["probes"]
    step_fn = steps.build_zkdl_step(pk.cfg, lr_shift=cell["lr_shift"],
                                    device=dev)
    hook = steps.ZkdlProveHook(pk, np.random.default_rng(ctx.seed),
                               verify=False, label=LABEL)
    ws: List[torch.Tensor] = []
    profiles: list = []
    # the proving session's phase profile, read before the hook opens
    # the next session
    hook.on_proof = lambda *_: profiles.append(hook._session.last_profile)
    produced = {"fps": [], "raws": [], "accepted": []}

    def cycle(k0: int, rec: tracing.Recording) -> dict:
        nonlocal ws
        t_c = time.perf_counter()
        ws = [w.clone() for w in checkpoint]
        step_s = []
        for k in range(k0, k0 + T):
            x, y = batch(inputs, k, dev)
            _sync(dev)
            t = time.perf_counter()
            with rec.span("trainer.step"):
                ws, wit = step_fn(ws, {"x": x, "y": y})
                _sync(dev)
            step_s.append(time.perf_counter() - t)
            produced["fps"].append(fingerprint(ws, probes))
            if k == k0 + T - 1:
                with rec.span("prover.prove"):
                    hook.observe(k, wit)
            else:
                hook.observe(k, wit)
        _, proof, _ = hook.proofs.pop()
        del wit
        with rec.span("proofio.encode"):
            raw = proofio.encode_proof(proof)
        t = time.perf_counter()
        with rec.span("verifier.verify_bytes"):
            ok = verifier.verify_bytes(vkey, raw, label=LABEL)
            _sync(dev)
        verify_s = time.perf_counter() - t
        produced["raws"].append(raw)
        produced["accepted"].append(bool(ok))
        prof = profiles.pop() if profiles else None
        if prof is None:
            raise RuntimeError("the prover's phase profile (ProofSession."
                               "last_profile) is missing: the per-layer "
                               "metrics of the prover read it")
        return {"step_s": step_s, "verify_s": verify_s, "accepted": bool(ok),
                "profile": prof.as_dict(),
                "cycle_s": time.perf_counter() - t_c, "traced": False}

    warm = cell["warm_windows"]
    for i in range(warm):
        cycle(i * T, tracing.Recording())
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    # -- the timed window -------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cycles: List[Dict] = []
    prof = None
    t_w = time.perf_counter()
    while True:
        traced = ctx.trace and not cycles
        with tracing.profiled(traced) as rec:
            c = cycle((warm + len(cycles)) * T, rec)
        if traced:
            c["traced"], prof = True, rec
        cycles.append(c)
        if time.perf_counter() - t_w >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_w
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    verified = T * sum(c["accepted"] for c in cycles)

    # -- after the window: the program's answers, then the reference ------
    trace = None
    if prof is not None:
        trace = tracing.summarize(*tracing.events(prof))
        trace["window_s"] = cycles[0]["cycle_s"]
        rest = [c["cycle_s"] for c in cycles[1:]]
        if rest:
            print(f"traced aggregation window {trace['window_s']:.4f} s, "
                  f"untraced ones {sum(rest) / len(rest):.4f} s on average",
                  file=sys.stderr)
        del prof
    counts = {str(c["profile"].get("counts")) for c in cycles}
    print(f"{len(cycles)} proofs of merged length {pk.cfg.merged_len}, "
          f"counts {' / '.join(sorted(counts))}", file=sys.stderr)
    produced["fps"] = [fp.cpu() for fp in produced["fps"]]
    produced["final_ws"] = [w.cpu() for w in ws]
    produced["tampered_accepted"] = verifier.verify_bytes(
        vkey, flip_ipa_byte(produced["raws"][-1]), label=LABEL)
    del pk, vkey, hook, step_fn, ws, checkpoint
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdict = judge(inputs, produced, geo, params, dev)
    timed = range(warm, warm + len(cycles))
    failed = sum(1 for i in timed if i in verdict["bad_windows"])
    return {"setup_s": setup_s,
            "e2e": {"verified_steps_per_s": verified / window_s,
                    "peak_device_gb": peak / 1e9},
            "memory_peak_bytes": peak, "checks": verdict["checks"],
            "attempted": len(cycles), "failed": failed, "trace": trace,
            "record": {"cycles": cycles, "geometry": geo, "trace": trace}}
