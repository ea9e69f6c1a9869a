"""The graph-first prover lifecycle: compile -> prove -> verify.

    graph = (GraphBuilder(batch=4).input(16)
             .dense(16).relu().dense(16).relu()
             .residual(to=1).dense(16).relu().output())
    pk, vk = compile(graph, quant=QuantConfig(16, 8), n_steps=T)

    session = ProofSession(pk)
    for wit in witnesses:                  # T of them
        session.add_step(wit)
    proof_bytes = encode_proof(session.prove())

    # any other process, from bytes alone:
    vk = decode_vk(vk_bytes)
    assert verify_bytes(vk, proof_bytes)

`compile` is the one-time setup: it freezes the graph's bucket and slot
layout into a `PipelineConfig` and derives every generator table on the
key's device (the card by default; ``device="cpu"`` runs the plain
versions).  The `VerifyingKey` carries just the geometry and re-derives
its generators on first use.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

from repro_torch._device import resolve_device
from repro_torch.core.quantfc import QuantConfig
from repro_torch.core.pipeline.config import (PipelineConfig, PipelineKeys,
                                              make_keys)
from repro_torch.core.pipeline.graph import LayerGraph


@dataclasses.dataclass(frozen=True)
class ProvingKey:
    """Prover-side setup artifact: config + full generator tables."""
    keys: PipelineKeys

    @property
    def cfg(self) -> PipelineConfig:
        return self.keys.cfg

    @property
    def graph(self) -> LayerGraph:
        return self.keys.cfg.graph

    @property
    def device(self):
        return self.keys.device

    def warm(self, seed: int = 0) -> dict:
        """Prove and verify one throwaway synthetic window, so the first
        real prove pays no kernel build or first-launch cost.  Returns
        the kernel build-cache stats delta (`repro_torch.core.execache`):
        a process that found every library on disk reports no misses."""
        import numpy as np

        from repro_torch.core import execache
        from repro_torch.core.quantfc import synthetic_sgd_trajectory_widths
        from repro_torch.core.pipeline.graph import graph_skips, graph_widths
        from repro_torch.core.pipeline.session import ProofSession

        before = execache.stats()
        cfg = self.cfg
        quant = QuantConfig(q_bits=cfg.q_bits, r_bits=cfg.r_bits)
        wits = synthetic_sgd_trajectory_widths(
            cfg.n_steps, graph_widths(cfg.graph), cfg.batch, quant,
            seed=seed, skips=graph_skips(cfg.graph), device=self.device)
        session = ProofSession(self, np.random.default_rng(seed))
        for wit in wits:
            session.add_step(wit)
        proof = session.prove()
        assert session.verify(proof), "warm-up proof rejected"
        after = execache.stats()
        return {k: after[k] - before[k] for k in after}

    def exec_stats(self) -> dict:
        """The kernel build-cache counters of this process."""
        from repro_torch.core import execache
        return execache.stats()


@dataclasses.dataclass(frozen=True)
class VerifyingKey:
    """Verifier-side setup artifact: graph + quantization geometry.

    Generator tables derive lazily on ``device`` (None: the card), so the
    key serializes to a few hundred bytes."""
    cfg: PipelineConfig
    device: object = dataclasses.field(default=None, compare=False)

    @functools.cached_property
    def keys(self) -> PipelineKeys:
        return make_keys(self.cfg, resolve_device(self.device))

    @property
    def graph(self) -> LayerGraph:
        return self.cfg.graph

    def to_bytes(self) -> bytes:
        from repro_torch.core.pipeline.proofio import encode_vk
        return encode_vk(self)

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "VerifyingKey":
        from repro_torch.core.pipeline.proofio import decode_vk
        return decode_vk(data, device=device)


def compile(graph: LayerGraph, quant: Optional[QuantConfig] = None,
            n_steps: int = 1, warm: bool = False,
            device=None) -> Tuple[ProvingKey, VerifyingKey]:
    """One-time setup for a proof graph: freeze the bucket/slot layout
    and derive the commitment generators on ``device`` (the card unless
    the caller passes ``device="cpu"``).  Returns ``(ProvingKey,
    VerifyingKey)``; both wrap the same deterministic derivation.
    ``warm=True`` additionally proves one throwaway window."""
    dev = resolve_device(device)
    quant = quant if quant is not None else QuantConfig()
    cfg = PipelineConfig.from_graph(graph, q_bits=quant.q_bits,
                                    r_bits=quant.r_bits, n_steps=n_steps)
    pk = ProvingKey(keys=make_keys(cfg, dev))
    if warm:
        pk.warm()
    return pk, VerifyingKey(cfg=cfg, device=dev)
