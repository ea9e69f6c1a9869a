"""Prove-while-train steps for provable integer-SGD families.

The zkDL part of the reference's `repro.launch.steps`: the layer-graph
pipeline config of a model config, the exact integer SGD step that
yields each batch's witness, and the hook that proves (and verifies)
one aggregated proof per window.  The reference's JAX model steps are
ROADMAP.md queue 1, item 16.
"""
from __future__ import annotations

import time

from repro_torch._device import resolve_device


def build_proof_pipeline_config(model_cfg, batch: int, n_steps: int,
                                q_bits: int = 16, r_bits: int = 8,
                                widths=None):
    """Model config -> graph-first `PipelineConfig`, gated by the
    proof-graph registry: a family without a registered layer-graph
    builder raises LookupError.  ``widths`` overrides the uniform
    d_0..d_L table derived from the model config."""
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.core.pipeline.graph import proof_graph_for_family

    if widths is None:
        widths = (model_cfg.d_model,) * (model_cfg.n_layers + 1)
    widths = tuple(int(w) for w in widths)
    graph = proof_graph_for_family(model_cfg.family, widths=widths,
                                   batch=batch)
    return PipelineConfig.from_graph(graph, q_bits=q_bits, r_bits=r_bits,
                                     n_steps=n_steps)


def build_zkdl_step(zk_cfg, lr_shift: int = 8, device=None):
    """Exact integer SGD step whose per-batch witness feeds the proof
    pipeline.  Returns ``step(ws, batch) -> (new_ws, StepWitness)`` with
    ``batch`` a dict of int64 arrays {"x": (B, d_0), "y": (B, d_L)} at
    scale 2^R; the witness and the updated weights are computed on
    ``device`` (default: the card)."""
    from repro_torch.core import quantfc

    qc = quantfc.QuantConfig(q_bits=zk_cfg.q_bits, r_bits=zk_cfg.r_bits)
    dev = resolve_device(device)

    def step(ws, batch):
        wit = quantfc.train_step_witness(batch["x"], batch["y"], ws, qc,
                                         device=dev)
        return quantfc.sgd_apply(wit.w, wit.gw, lr_shift, qc), wit

    return step


class ZkdlProveHook:
    """Prove-while-train: observe each step's witness; every
    ``keys.cfg.n_steps`` steps one aggregated proof covering the window
    is emitted (and optionally verified) through a new `ProofSession`.
    Every session shares the caller's numpy ``rng``, so the blinds
    continue one host stream across windows."""

    def __init__(self, keys, rng, verify: bool = True, on_proof=None,
                 label: bytes = b"zkdl/train"):
        from repro_torch.core.pipeline import ProofSession

        self._mk = lambda: ProofSession(keys, rng, label=label)
        self._session = self._mk()
        self.keys = keys
        self.verify = verify
        self.on_proof = on_proof
        self.proofs = []           # (last_step, proof, prove_seconds)

    @property
    def n_pending(self) -> int:
        return self._session.n_pending

    def observe(self, step: int, wit) -> None:
        self._session.add_step(wit)
        if not self._session.is_full:
            return
        t0 = time.perf_counter()
        proof = self._session.prove()
        dt = time.perf_counter() - t0
        if self.verify and not self._session.verify(proof):
            raise RuntimeError(f"aggregated proof REJECTED at step {step}")
        self.proofs.append((step, proof, dt))
        if self.on_proof is not None:
            self.on_proof(step, proof, dt)
        self._session = self._mk()
