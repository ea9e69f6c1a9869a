"""A cell at a size the CPU proves in seconds, for the tests."""
import time
from unittest import mock

from zkbench import harness

CONFIG = {"name": "tiny", "n_layers": 2, "d_model": 8, "batch": 4,
          "q_bits": 16, "r_bits": 8}
CELL = {"name": "tiny-t1", "config": "tiny", "driver": "train_prove_verify",
        "traffic": "tiny", "chips": 1, "window_steps": 1, "weight_gain": 2.0,
        "data_gain": 1.0, "label_gain": 1.0, "lr_shift": 4, "batch_pool": 8,
        "warm_windows": 0}


def bench():
    """A BENCHMARK.json naming the tiny cell in every metric."""
    b = harness.benchmark()
    for m in b["per_layer"]:
        m["workloads"] = [CELL["name"]]
    return b


def run(seed=7, trace=False):
    """One run of the tiny cell on the CPU, found by name as a cell of
    the repository is."""
    b = bench()
    with mock.patch.object(harness, "load_cell", lambda name: CELL), \
            mock.patch.object(harness, "load_config", lambda name: CONFIG), \
            mock.patch.object(harness, "benchmark", lambda: b):
        return harness.run_cell(CELL["name"], seed, 0.0, trace, "cpu",
                                time.perf_counter())
