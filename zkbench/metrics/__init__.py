"""Per-layer metric readers, one file per metric, named as the metric.

Each holds ``read(record) -> float | None`` over the driver's record;
its layer, unit, source and the end-to-end metric it moves are in
`BENCHMARK.json`.  A reader that finds nothing to read returns None, and
the metric is left out of the result line."""
from __future__ import annotations

from typing import List, Optional


def untraced(record: dict) -> List[dict]:
    """The window's aggregation windows that ran without the profiler
    (all of them when every one was traced)."""
    cycles = record["cycles"]
    return [c for c in cycles if not c["traced"]] or cycles


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def profile_mean(record: dict, key: str, name: str) -> Optional[float]:
    """Seconds per proof of one entry of the prover's phase profile
    (``key``: "phases_s" or "sub_phases_s")."""
    return mean([c["profile"][key][name] for c in untraced(record)
                 if c["profile"] and name in c["profile"].get(key, {})])
