"""Runs one cell once and builds its result line.

Everything a cell needs is found by name: its file
``zkbench/workloads/<cell>.json`` names a configuration
(``zkbench/configs/<config>.json``) and a driver
(``zkbench/drivers/<driver>.py``); `BENCHMARK.json` names the cell's
metrics, and each per-layer metric is read by
``zkbench/metrics/<metric>.py``.  A driver's ``run(ctx)`` returns::

    {"setup_s", "e2e": {metric: value}, "memory_peak_bytes",
     "checks": {name: (value, limit)}, "attempted", "failed",
     "trace": None or {"busy_s", "window_s", "device_ops", "idle_gaps"},
     "record": what the metric readers read: {"cycles", "geometry",
               "trace"}}
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from typing import Dict, List

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level modules that may not be loaded in a run: JAX and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> dict:
    return load_json(BENCH_DIR / "workloads" / f"{name}.json")


def load_config(name: str) -> dict:
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def load_module(kind: str, name: str):
    """``zkbench/<kind>/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"zkbench.{kind}.{name}", BENCH_DIR / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries reported in ``cell``."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def loaded_forbidden() -> List[str]:
    """Names in `FORBIDDEN` loaded in this process, compared by whole
    top-level module names."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> dict:
    """One run of a cell; the result line as a dict (``checks`` last)."""
    cell = load_cell(name)
    config = load_config(cell["config"])
    bench = benchmark()
    driver = load_module("drivers", cell["driver"])
    out = driver.run(Context(cell, config, seed, seconds, trace, device,
                             t_start))
    metrics: Dict[str, dict] = {}
    if not trace:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for m in cell_metrics(bench, name, "end_to_end"):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, name, "per_layer"):
            value = load_module("metrics", m["name"]).read(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    import torch
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": all(v <= lim for v, lim in out["checks"].values())
              and out["attempted"] > 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if out["trace"] is not None:
        tr = out["trace"]
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out["checks"].items()}
    return result


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines of
    standard error, then the result as the last line of standard
    output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
