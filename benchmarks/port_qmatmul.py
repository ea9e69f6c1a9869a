"""Time the port's whole exact int16 matmul, `qmatmul_i64`, on the card.

    python3 benchmarks/port_qmatmul.py [--src DIR] [--reps N] [--out FILE]

Times ``repro_torch.kernels.qmatmul.qmatmul_i64`` at the three witness
shapes of the fcnn-zkdl-16l width, with the witness's operand layouts
(``chip_smoke.QMATMUL_SHAPES``), as ``chip_smoke.py`` phase ``kernels``
does (``chip_smoke.time_qmatmul``: device time, host-loop time, bound,
four ``torch._int_mm``).  ``--src`` imports ``repro_torch`` from another
source tree, such as an unpacked earlier commit, so that two versions of
the kernel are timed by the same code.  Prints one JSON object with the
card's name and power limit; needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (QMATMUL_SHAPES, _int16, _views,  # noqa: E402
                        nvidia_smi, time_qmatmul)


def run(src: str, reps: int) -> dict:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch.kernels import qmatmul as qk

    rng = np.random.default_rng(0)
    out = {}
    for name, ((m, k, n), a_t, b_t) in QMATMUL_SHAPES.items():
        a, b = _views(_int16(rng, (m, k)), _int16(rng, (k, n)), a_t, b_t,
                      "cuda")
        out[name] = time_qmatmul(qk.qmatmul_i64, a, b, reps)
        del a, b
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("port_qmatmul: needs a GPU", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    res = {"src": src, "nvidia_smi": nvidia_smi(), "reps": args.reps,
           "shapes": run(src, args.reps)}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
