"""Per-phase prover wall-clock profiler.

The aggregated prover runs in well-separated phases (witness stacking,
the commitment phase, challenge derivation, the bucketed matmul
sumchecks, the anchor sumcheck, and the step-(c) openings); attributing
prove time to phases is what lets a perf PR claim "the win came from the
commitment batching" instead of pointing at end-to-end noise.  The
profiler is always on -- a handful of ``perf_counter`` calls per prove,
each after a device synchronize -- and surfaces through
``ProofSession.last_profile``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict

import torch

from repro_torch.core.pipeline.graph import FAMILIES


def _sync() -> None:
    """Wait for queued card work, so a phase's seconds are its own
    (kernel launches return before the card finishes)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# canonical phase order (rendering / JSON emission)
PHASES = ("stack", "commit", "challenges", "matmul", "anchor", "openings")

# sub-phases of the dominant `openings` phase: claim combination (the
# per-tensor rho folds, the direct-sum assembly AND the merged-vector
# concatenation), the merged pair-IPA's L/R round loop, its final
# Schnorr opening, and the zkReLU validity statement/table preparation
# (challenge draws + the validity-table kernel; the validity IPA
# itself rides the merged pair IPA and is accounted under ipa-rounds/
# sigma).  Tracked separately from `phases_s` so `accounted_s` (which
# the --smoke attribution check compares against total_s) never double
# counts.
# The `matmul` phase splits into one sub-phase per relation family, each
# over all of that family's shape buckets (table fixing, the per-bucket
# claim split and the batched sumchecks).
SUB_PHASES = ("claim-combine", "ipa-rounds", "sigma", "zkrelu-validity",
              "sumcheck-fwd", "sumcheck-bwd", "sumcheck-gw")


def subphase(prof, name: str):
    """Sub-phase context of an OPTIONAL profile: `prof.subphase(name)`
    when a `PhaseProfile` is passed, a no-op context otherwise — the
    shared helper for call sites whose profiler argument defaults to
    None (ipa.open_prove, openings.prove)."""
    return (prof.subphase(name) if prof is not None
            else contextlib.nullcontext())


@dataclasses.dataclass
class PhaseProfile:
    """Accumulated per-phase seconds plus the end-to-end total."""

    phases_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    sub_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    total_s: float = 0.0

    @contextlib.contextmanager
    def phase(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.phases_s[name] = (self.phases_s.get(name, 0.0)
                                   + time.perf_counter() - t0)

    @contextlib.contextmanager
    def subphase(self, name: str):
        """Nested attribution inside a phase (openings sub-phases); does
        NOT contribute to `accounted_s`."""
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.sub_s[name] = (self.sub_s.get(name, 0.0)
                                + time.perf_counter() - t0)

    @property
    def accounted_s(self) -> float:
        """Sum of the recorded top-level phases (should be ~total_s; the
        residual is proof-object assembly and python glue)."""
        return sum(self.phases_s.values())

    def as_dict(self) -> Dict:
        ordered = {k: self.phases_s[k] for k in PHASES if k in self.phases_s}
        ordered.update({k: v for k, v in self.phases_s.items()
                        if k not in ordered})
        out = {"total_s": self.total_s,
               "accounted_s": self.accounted_s,
               "phases_s": ordered}
        if self.sub_s:
            sub = {k: self.sub_s[k] for k in SUB_PHASES if k in self.sub_s}
            sub.update({k: v for k, v in self.sub_s.items()
                        if k not in sub})
            out["sub_phases_s"] = sub
        if self.counts:
            out["counts"] = dict(self.counts)
        return out


def proof_counts(cfg) -> Dict[str, int]:
    """What one proof under a `PipelineConfig` holds (the profile's
    ``counts``): ``buckets``, the shape buckets over the three relation
    families; ``aux_real``, the unpadded elements of one stacked aux
    tensor (T x every aux node's batch x width); ``aux_stacked``, that
    tensor's stacked length; ``validity_positions``, the (row, bit)
    positions of both zkReLU validity statements."""
    g = cfg.graph
    return {"buckets": sum(len(g.buckets[f]) for f in FAMILIES),
            "aux_real": cfg.n_steps * sum(n.shape[0] * n.shape[1]
                                          for n in g.aux_nodes),
            "aux_stacked": cfg.d_stack,
            "validity_positions": sum(n for _, _, n in cfg.validity_blocks)}
