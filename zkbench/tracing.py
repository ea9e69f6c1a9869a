"""What a traced run reads: each device kernel's interval from
`torch.profiler` (the device's activity only, so that the host runs at
its untraced pace), the benchmark's own spans around the calls into
each layer, timed on the host's Unix clock (the clock of the profiler's
timestamps), and from them the device's busy time (the union of kernel
intervals), kernel seconds by name, and the idle gaps labelled by the
span the host was in."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

TOP = 10


class Recording:
    """One aggregation window's record: the profiler (None where the
    window is not traced), and the benchmark's spans as ``(name,
    start_us, end_us)`` on the host's Unix clock."""

    def __init__(self, prof=None):
        self.prof = prof
        self.spans: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        """A benchmark span around a call into a layer."""
        t0 = time.time_ns()
        yield
        self.spans.append((name, t0 / 1e3, time.time_ns() / 1e3))


@contextlib.contextmanager
def profiled(enabled: bool):
    """A `Recording`, under a torch.profiler of the device's activity
    while ``enabled``."""
    if not enabled:
        yield Recording()
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield Recording(prof)


def events(rec: Recording) -> Tuple[list, list]:
    """(kernels, spans) of a finished recording: ``[(name, start_us,
    end_us)]`` of every device operation, read from the raw Kineto
    events (which skips building the profiler's event tree), and the
    benchmark's spans."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(ev.name(), ev.start_ns() / 1e3, ev.end_ns() / 1e3)
               for ev in rec.prof.profiler.kineto_results.events()
               if ev.device_type() == cuda and not ev.is_user_annotation()]
    return kernels, rec.spans


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(kernels: list, spans: list) -> Dict:
    """Device seconds by kernel name, busy seconds, and the longest
    idle gaps inside the spans' extent, each with the span covering
    it ("host" where none does)."""
    by_name: Dict[str, List[float]] = {}
    for name, start, end in kernels:
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (end - start) / 1e6
    busy = union([(s, e) for _, s, e in kernels])
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps = []
    if spans and busy:
        lo = min(s for _, s, _ in spans)
        hi = max(e for _, _, e in spans)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for start, end in zip(edges[0::2], edges[1::2]):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            mid = (start + end) / 2
            label = next((n for n, s, e in spans if s <= mid <= e), "host")
            gaps.append((label, (end - start) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"kernels": by_name, "busy_s": busy_s,
            "device_ops": [[n[:120], row[1]] for n, row in ops[:TOP]],
            "idle_gaps": [[label, s] for label, s in gaps[:TOP]]}


def kernel_name(name: str) -> str:
    """A device kernel's own name: its demangled signature without the
    return type, template arguments or parameters."""
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name


def kernel_seconds(trace: Dict, kernel: str) -> Tuple[int, float]:
    """(launches, device seconds) of the kernel named ``kernel``."""
    count, secs = 0, 0.0
    for name, (n, s) in trace["kernels"].items():
        if kernel_name(name) == kernel:
            count += n
            secs += s
    return count, secs
