"""Multi-pod dry run: every (architecture x input-shape) cell run once on
the production meshes, per device, with no device: figures for the
roofline analysis (the reference's `repro.launch.dryrun`).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \
        [--out results/] [--jobs 8]

The first act of ``main()`` starts a fake process group of 256 ranks
(512 with ``--multi-pod`` or ``--both-meshes``), as the reference's
entry point forces 512 XLA host devices before JAX starts; nothing else
in the repo makes a fake group, and importing this module makes none.
Each cell builds its inputs as DTensors on the 16x16 or 2x16x16
DeviceMesh, placed by the sharding rules, whose shards are ``meta``
tensors (no memory), and runs the step once under `steps.StepMeter`:
flops by torch's formulas, bytes read and written, the operand bytes of
every collective DTensor dispatches, argument and output bytes from the
local shard shapes, and the peak of live local bytes.  The fake group
moves no data, so only shapes are computed.  ``--jobs N`` runs N cells
at once, each in a process (and a fake group) of its own.

The terms are against the datasheet peaks of one NVIDIA H100 SXM5 80GB
(the 700 W part): 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 450 GB/s of
NVLink per direction.  They are not measurements.  The fake group's
mesh is a ``cpu`` mesh, on which DTensor runs a shard-to-shard
redistribution as an all-gather and a chunk, so such moves count as
all-gather, not all-to-all.
"""
import argparse
import json
import os
import time
import traceback

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM5 datasheet (700 W)
HBM_BW = 3.35e12             # bytes/s, HBM3, datasheet
ICI_BW = 450e9               # bytes/s, the interconnect: NVLink 4 per
                             # direction, datasheet

# keys of the reference's record that have no counterpart here
COVERS = [
    {"key": "per_device_collective_bytes_unscaled",
     "why": "eager execution runs each collective as often as it is "
            "executed, so there is no loop body counted once to scale"},
    {"key": "collective_breakdown_unscaled",
     "why": "as per_device_collective_bytes_unscaled"},
    {"key": "memory.generated_code_size_in_bytes",
     "why": "eager execution generates no program"},
    {"key": "memory.temp_size_in_bytes",
     "why": "no buffer assignment: per_device_live_bytes is the measured "
            "peak of live local bytes, arguments included"},
    {"key": "memory.alias_size_in_bytes",
     "why": "no donation: the new state is live beside the old until the "
            "step returns, as in the trainer"},
]


def init_fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks (this process is rank 0):
    collectives move nothing, so a DeviceMesh of any size builds here."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def analyze_compiled(compiled, n_chips: int) -> dict:
    """The reference's record keys from one metered run of a cell."""
    coll = sum(compiled.collectives.values())
    memory = {"argument_size_in_bytes": compiled.argument_bytes,
              "output_size_in_bytes": compiled.output_bytes}
    return {
        "per_device_flops": compiled.flops,
        "per_device_bytes": compiled.bytes_accessed,
        "per_device_collective_bytes": coll,
        "collective_breakdown": dict(compiled.collectives),
        "memory": memory,
        "per_device_live_bytes": compiled.peak_live_bytes,
        "compute_term_s": compiled.flops / PEAK_FLOPS,
        "memory_term_s": compiled.bytes_accessed / HBM_BW,
        "collective_term_s": coll / ICI_BW,
        "n_chips": n_chips,
        "covers": COVERS,
    }


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             out_dir: str | None = None) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import hints
    from repro_torch.launch import specs as specs_mod
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import lower_cell

    cfg = get_config(arch)
    ok, why = specs_mod.applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        print(f"[dryrun] {arch} x {shape}: SKIP ({why})", flush=True)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    t0 = time.time()
    try:
        lowered = lower_cell(cfg, mesh, shape)
        t_lower = time.time() - t0
        t0 = time.time()
        compiled = lowered.compile()
        t_compile = time.time() - t0
        rec.update(analyze_compiled(compiled, n_chips))
        rec["status"] = "ok"
        rec["lower_s"] = round(t_lower, 1)
        rec["compile_s"] = round(t_compile, 1)
        print(f"[dryrun] {arch} x {shape} ({rec['mesh']}): OK  "
              f"lower {t_lower:.0f}s run {t_compile:.0f}s  "
              f"flops/dev {rec['per_device_flops']:.3e}  "
              f"bytes/dev {rec['per_device_bytes']:.3e}  "
              f"coll/dev {rec['per_device_collective_bytes']:.3e}  "
              f"live/dev {rec['per_device_live_bytes'] / 2**30:.2f} GiB",
              flush=True)
        print("  memory:", rec["memory"], flush=True)
    except Exception as exc:            # noqa: BLE001 -- report, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(exc).__name__}: {exc}"
        traceback.print_exc()
        print(f"[dryrun] {arch} x {shape}: FAILED {rec['error'][:200]}",
              flush=True)
    finally:
        hints.clear()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(_record_path(out_dir, arch, shape, rec["mesh"]), "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


def _record_path(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__"
                                 f"{mesh.replace('x', '_')}.json")


def _run_cells_in_processes(cells, out_dir: str, jobs: int) -> list:
    """``run_cell`` of each (arch, shape, multi_pod) in a child process
    of this CLI, ``jobs`` at once; their records come back through
    ``out_dir``."""
    import subprocess
    import sys

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.specs import applicable

    pending, running, done = list(cells), {}, {}
    while pending or running:
        while pending and len(running) < jobs:
            arch, shape, mp = cell = pending.pop(0)
            if not applicable(get_config(arch), shape)[0]:
                done[cell] = run_cell(arch, shape, mp)
                continue
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--out", out_dir]
            running[cell] = subprocess.Popen(
                argv + (["--multi-pod"] if mp else []))
        time.sleep(0.2)
        for cell, proc in list(running.items()):
            if proc.poll() is None:
                continue
            del running[cell]
            arch, shape, mp = cell
            path = _record_path(out_dir, arch, shape,
                                "2x16x16" if mp else "16x16")
            if proc.returncode == 0 and os.path.exists(path):
                with open(path) as f:
                    done[cell] = json.load(f)
            else:
                done[cell] = {"arch": arch, "shape": shape, "status": "error",
                              "error": f"cell process exited "
                                       f"{proc.returncode}"}
    return [done[c] for c in cells]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at once, each in a process of its own")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")
    init_fake_world(512 if (args.multi_pod or args.both_meshes) else 256)

    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.specs import SHAPE_GRID

    lm_archs = [a for a in ARCHS if a != "fcnn_zkdl_16l"]
    cells = []
    if args.all:
        for a in lm_archs:
            for s in SHAPE_GRID:
                cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    cells = [(arch, shape, mp) for mp in meshes for arch, shape in cells]
    if args.jobs > 1:
        results = _run_cells_in_processes(cells, args.out, args.jobs)
    else:
        results = [run_cell(arch, shape, mp, args.out)
                   for arch, shape, mp in cells]
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} failed",
          flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
