"""The readings that set the limits of ``correct``, at a cell's own size.

    python3 zkbench/control.py --workload <cell> --seeds 1,2,3 [--steps N]

For each seed the cell's inputs are drawn as a run draws them, and the
exact reference is replayed over ``N`` steps.  Each variant is then put
in the program's place and its weight numbers read against the exact
replay, as `drivers.train_prove_verify.judge` reads the program's:

* ``control``: the reference with every product's operands rounded to
  int8 (`reference.sgd.int8_matmul`), the precision below the
  configuration's 16-bit one;
* ``unchanged``: a step that returns its weights unchanged;
* ``half_batch``: half of each batch left out, the update doubled (the
  mean over the rest).

The benchmark's own runs do not run this.  One JSON line per seed.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]


def half_batch_step(ws, x, y, q_bits, r_bits, lr_shift, matmul):
    from zkbench.reference import sgd
    half = x.shape[0] // 2
    x, y = x.clone(), y.clone()
    x[half:] = 0
    y[half:] = 0
    return sgd.sgd_step(ws, x, y, q_bits, r_bits, lr_shift - 1, matmul)


def unchanged_step(ws, x, y, q_bits, r_bits, lr_shift, matmul):
    from zkbench.reference import sgd
    _, tensors = sgd.sgd_step(ws, x, y, q_bits, r_bits, lr_shift, matmul)
    return ws, tensors


def variant_numbers(inputs: dict, params: dict, n_steps: int, dev,
                    variant: str) -> dict:
    """step_weights_off and final_weights_off of one variant in the
    program's place, against the exact replay."""
    from zkbench.drivers import train_prove_verify as drv
    from zkbench.reference import sgd

    kw = {"control": {"matmul": sgd.int8_matmul},
          "unchanged": {"step": unchanged_step},
          "half_batch": {"step": half_batch_step}}[variant]
    exact = drv.replay(inputs, params, n_steps, dev)
    other = drv.replay(inputs, params, n_steps, dev, **kw)
    fp_off = 0
    for _ in range(n_steps):
        fp_off += int((next(exact)[0] != next(other)[0]).sum())
    final_off = sum(int((a != b).sum())
                    for a, b in zip(next(exact)[0], next(other)[0]))
    return {"step_weights_off": fp_off, "final_weights_off": final_off}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=0,
                    help="steps to replay (default: 8 windows)")
    args = ap.parse_args(argv)

    import torch

    from zkbench import harness
    from zkbench.drivers import train_prove_verify as drv

    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    config = harness.load_config(cell["config"])
    geo = drv.geometry(config, cell)
    params = {"q_bits": geo.q_bits, "r_bits": geo.r_bits,
              "lr_shift": cell["lr_shift"], "window_steps": geo.n_steps}
    n_steps = args.steps or 8 * geo.n_steps
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = drv.make_inputs(config, cell, seed, "cuda")
        inputs["ws"] = [w.cpu() for w in inputs["ws"]]
        out = {"workload": args.workload, "seed": seed, "steps": n_steps}
        for variant in ("control", "unchanged", "half_batch"):
            out[variant] = variant_numbers(inputs, params, n_steps, "cuda",
                                           variant)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
