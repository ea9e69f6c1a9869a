"""`control.py`'s readings for a cell run by
`drivers/train_prove_verify_widths.py`, at the cell's own size.

    python3 zkbench/control_widths.py --workload <cell> --seeds 1,2,3 [--steps N]

The same three variants in the program's place (``control``: every
product's operands rounded to int8; ``unchanged``; ``half_batch``),
each read against the exact replay over ``N`` steps as that module's
`judge` reads the program.  The benchmark's own runs do not run this.
One JSON line per seed.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]


def variant_numbers(inputs: dict, params: dict, n_steps: int, dev,
                    variant: str) -> dict:
    """step_weights_off and final_weights_off of one variant in the
    program's place, against the exact replay."""
    from zkbench import control
    from zkbench.drivers import train_prove_verify_widths as drv
    from zkbench.reference import sgd

    kw = {"control": {"matmul": sgd.int8_matmul},
          "unchanged": {"step": control.unchanged_step},
          "half_batch": {"step": control.half_batch_step}}[variant]
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
    from zkbench.drivers import train_prove_verify_widths as drv

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
