"""The control at a size a test run holds: the reference put in the
program's place in the precision below the configuration's (int8
operands) fails the weight numbers, as do the planted faults; the exact
reference in the program's place reads 0.  On the card,
`zkbench/control.py` reads the same numbers at each cell's own size."""
import pytest

from zkbench import control
from zkbench.drivers import train_prove_verify as drv

import zkbench_tiny

CONFIG = dict(zkbench_tiny.CONFIG, d_model=64, batch=8)


@pytest.mark.parametrize("seed", [3, 2**31 + 3])
def test_control_fails_and_exact_passes(seed):
    inputs = drv.make_inputs(CONFIG, zkbench_tiny.CELL, seed, "cpu")
    params = {"q_bits": 16, "r_bits": 8, "lr_shift": 16,
              "window_steps": 2}
    for variant in ("control", "unchanged", "half_batch"):
        got = control.variant_numbers(inputs, params, 4, "cpu", variant)
        assert got["step_weights_off"] > 0, variant
        assert got["final_weights_off"] > 0, variant
    exact = drv.replay(inputs, params, 4, "cpu")
    again = drv.replay(inputs, params, 4, "cpu")
    for _ in range(5):
        a, b = next(exact)[0], next(again)[0]
        assert all((x == y).all() for x, y in zip(a, b))
