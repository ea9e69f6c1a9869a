"""Train / prefill / decode steps (the reference's `repro.launch.steps`).

Two halves.  For provable integer-SGD families: the layer-graph
pipeline config of a model config, the exact integer SGD step that
yields each batch's witness, and the hook that proves (and verifies)
one aggregated proof per window.  For the LM families: the AdamW train
step, the prefill and decode steps and the state's shapes, on one
device.  The reference's mesh pieces (`state_shardings`, `lower_cell`)
wait for the port's mesh code (ROADMAP.md queue 1, item F).
"""
from __future__ import annotations

import time

import torch

from repro_torch._device import resolve_device
from repro_torch.tree import tree_leaves, tree_unflatten


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


# ---------------------------------------------------------------------------
# LM families
# ---------------------------------------------------------------------------

def value_and_grad(cfg, params, batch):
    """(loss, grads): the loss of ``params`` on ``batch`` and its
    gradient tree, from detached copies of the leaves (the caller's
    tree is not touched)."""
    from repro_torch.models import transformer

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    loss = transformer.loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def build_train_step(cfg, opt_cfg):
    """``train_step(state, batch) -> (new_state, metrics)`` for state
    ``{"params", "opt"}``: one AdamW step on the loss's gradient."""
    from repro_torch.train import optim

    def train_step(state, batch):
        loss, grads = value_and_grad(cfg, state["params"], batch)
        new_params, new_opt, metrics = optim.apply_updates(
            opt_cfg, state["params"], grads, state["opt"])
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics
    return train_step


def build_prefill_step(cfg):
    from repro_torch.models import transformer

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, caches = transformer.forward(cfg, params, batch,
                                             collect_cache=True,
                                             head_last_only=True)
        return logits[:, -1], caches
    return prefill_step


def build_decode_step(cfg):
    from repro_torch.models import transformer

    @torch.no_grad()
    def decode_step(params, cache, token, pos, positions3=None):
        return transformer.decode_step(cfg, params, cache, token, pos,
                                       positions3=positions3)
    return decode_step


def default_opt_cfg(cfg):
    """bf16 Adam moments for >=100B-param models."""
    from repro_torch.train import optim

    big = cfg.param_count() > 100e9
    return optim.AdamWConfig(state_dtype="bfloat16" if big else "float32")


def state_specs(cfg, opt_cfg):
    """The train state's tree with every leaf on the ``meta`` device:
    shapes and dtypes, no memory."""
    from repro_torch.models import transformer
    from repro_torch.train import optim

    p = transformer.init_params(cfg, torch.device("meta"))
    return {"params": p, "opt": optim.init_opt_state(p, opt_cfg)}
