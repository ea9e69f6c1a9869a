"""AdamW implemented natively (the reference's `repro.train.optim`).

State is a tree mirroring params (mu, nu) plus a scalar step tensor,
so it is saved and restored leaf by leaf like the parameters.  Updates
are out of place, with the reference's clip, warm-up and bias
correction, all in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # bf16 moments halve the optimizer's memory; the float32 master
    # parameters are kept either way
    state_dtype: str = "float32"


def init_opt_state(params, cfg: AdamWConfig = AdamWConfig()) -> Dict[str, Any]:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                 device=p.device), params),
            "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                 device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed in
    the reference's leaf order (sorted keys)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (new_params, new_opt_state, metrics)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = (g * scale).float()
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = mf / b1c
        vhat = vf / b2c
        new_p = (p.float()
                 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                         + cfg.weight_decay * p.float()))
        return new_p.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    flat_p = tree_leaves(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), tree_leaves(opt_state["mu"]),
        tree_leaves(opt_state["nu"]))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(params, [o[1] for o in out])
    new_nu = tree_unflatten(params, [o[2] for o in out])
    return (new_params, {"mu": new_mu, "nu": new_nu, "step": step},
            {"grad_norm": gnorm, "lr": lr})
