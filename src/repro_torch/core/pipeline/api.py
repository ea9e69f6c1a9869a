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
        """Prove and verify one throwaway window (`warm_witnesses`), so
        the first real prove pays no kernel build or first-launch cost.
        Returns the kernel build-cache stats delta
        (`repro_torch.core.execache`): a process that found every library
        on disk reports no misses."""
        import numpy as np

        from repro_torch.core import execache
        from repro_torch.core.pipeline.session import ProofSession

        before = execache.stats()
        session = ProofSession(self, np.random.default_rng(seed))
        for wit in warm_witnesses(self.cfg, seed, self.device):
            session.add_step(wit)
        proof = session.prove()
        assert session.verify(proof), "warm-up proof rejected"
        after = execache.stats()
        return {k: after[k] - before[k] for k in after}

    def exec_stats(self) -> dict:
        """The kernel build-cache counters of this process."""
        from repro_torch.core import execache
        return execache.stats()


def warm_witnesses(cfg: PipelineConfig, seed: int, device) -> list:
    """``cfg.n_steps`` throwaway step witnesses at the key's geometry for
    `ProvingKey.warm`: weights from ``seed`` scaled by 2/sqrt(fan-in),
    fresh data each step, no SGD update between steps (no relation of
    the proof binds one step's weights to the next).  The rescaled
    activations and gradients stay near 2^R at any width, far inside the
    Q-bit range.  The reference warms on its synthetic SGD stream, whose
    0.3-scaled weights overflow that range at batch 128 from width 128 on
    (its `OverflowError`); nothing of a warm-up reaches any proof byte."""
    import numpy as np

    from repro_torch.core.pipeline.graph import graph_skips, graph_widths
    from repro_torch.core.quantfc import quantize, train_step_witness

    quant = QuantConfig(q_bits=cfg.q_bits, r_bits=cfg.r_bits)
    widths = graph_widths(cfg.graph)
    rng = np.random.default_rng(seed)
    ws = [quantize(rng.uniform(-1, 1, (widths[l], widths[l + 1]))
                   * (2 / widths[l] ** 0.5), quant)
          for l in range(len(widths) - 1)]
    wits = []
    for _ in range(cfg.n_steps):
        x = quantize(rng.uniform(-1, 1, (cfg.batch, widths[0])), quant)
        y = quantize(rng.uniform(-1, 1, (cfg.batch, widths[-1])), quant)
        wits.append(train_step_witness(x, y, ws, quant,
                                       skips=graph_skips(cfg.graph),
                                       device=device))
    return wits


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
