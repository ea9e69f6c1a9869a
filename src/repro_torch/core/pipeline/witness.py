"""Witness stacking: T `StepWitness`es -> one stacked proof witness.

Stacking is driven by the layer graph's commitment schema
(`LayerGraph.commit_slots`): each named tensor slot becomes one stacked
int64 vector, with each node's tensor at ``cfg.slot(t, aux slot)`` (aux
axis) / ``cfg.wslot(t, weight slot)`` (weight axis) / step ``t`` (label
axis), element variables low, node variables next, step variables on
top.  Heterogeneous shapes zero-pad per dimension to powers of two and
then to the common slot area.  Everything stays on the witnesses'
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.core.quantfc import StepWitness
from repro_torch.core.pipeline.config import PipelineConfig
from repro_torch.core.pipeline.graph import extract_node_tensors
from repro_torch.core.pipeline.tables import enc_tensor


def pad2d(tensor: torch.Tensor, rows_pad: int, cols_pad: int) -> torch.Tensor:
    """(r, c) int64 -> (rows_pad, cols_pad) with zero padding."""
    r, c = tensor.shape
    assert r <= rows_pad and c <= cols_pad, (tensor.shape, rows_pad, cols_pad)
    if (r, c) == (rows_pad, cols_pad):
        return tensor
    out = torch.zeros((rows_pad, cols_pad), dtype=tensor.dtype,
                      device=tensor.device)
    out[:r, :c] = tensor
    return out


def node_tensors(cfg: PipelineConfig, wit: StepWitness) -> Dict[str, Dict]:
    return extract_node_tensors(cfg.graph, wit)


@dataclasses.dataclass
class StackedWitness:
    """Slot-keyed stacked int64 tensors plus the per-step raw witnesses.

    ``tensors[name]`` is the stacked vector of commitment slot `name`;
    the ``<name>_s`` attributes resolve through it."""
    cfg: PipelineConfig
    steps: List[StepWitness]
    tensors: Dict[str, torch.Tensor]
    x: List[torch.Tensor]    # T*B per-sample rows (x_len,), t-major

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def __getattr__(self, name: str):
        if name.endswith("_s"):
            try:
                return self.tensors[name[:-2]]
            except KeyError:
                pass
        raise AttributeError(name)


def _stack_slot(cfg: PipelineConfig, spec, per_step, device) -> torch.Tensor:
    """One commitment slot's tensors of every (step, node) -> stacked."""
    g = cfg.graph
    if spec.axis == "aux":
        shape = (cfg.t_pad, cfg.l_pad, cfg.d_elem)
    elif spec.axis == "weight":
        shape = (cfg.t_pad, cfg.lw_pad, cfg.w_elem)
    else:                                     # label: per-step, no node axis
        shape = (cfg.t_pad, 1, cfg.y_elem)
    out = torch.zeros(shape, dtype=torch.int64, device=device)
    for t, tensors in enumerate(per_step):
        for i, node in enumerate(g.slot_nodes(spec)):
            if spec.name not in tensors[node.name]:
                continue
            rp, cp = g.slot_pad_shape(spec, node)
            out[t, i, : rp * cp] = pad2d(tensors[node.name][spec.name],
                                         rp, cp).reshape(-1)
    return out.reshape(-1)


def stack_witnesses(steps: List[StepWitness],
                    cfg: PipelineConfig) -> StackedWitness:
    if len(steps) != cfg.n_steps:
        raise ValueError(
            f"session holds {len(steps)} step witnesses, "
            f"config requires exactly {cfg.n_steps}")
    g = cfg.graph
    for t, wit in enumerate(steps):
        if wit.n_layers != cfg.n_layers:
            raise ValueError(f"step {t}: {wit.n_layers} layers != "
                             f"{cfg.n_layers}")
        if tuple(wit.x.shape) != (cfg.batch, cfg.widths[0]):
            raise ValueError(f"step {t}: x shape {tuple(wit.x.shape)} != "
                             f"{(cfg.batch, cfg.widths[0])}")
        for l in range(1, cfg.n_layers + 1):
            want = (cfg.widths[l - 1], cfg.widths[l])
            if tuple(wit.w[l - 1].shape) != want:
                raise ValueError(f"step {t}: W^{l} shape "
                                 f"{tuple(wit.w[l - 1].shape)} != {want}")

    device = steps[0].x.device
    per_step = [node_tensors(cfg, wit) for wit in steps]
    tensors = {spec.name: _stack_slot(cfg, spec, per_step, device)
               for spec in g.commit_slots}

    x_node = g.input_node
    xs: List[torch.Tensor] = []
    for wit in steps:
        x_pad = pad2d(wit.x, cfg.batch, x_node.cols_pad)
        xs.extend(x_pad[i] for i in range(cfg.batch))

    return StackedWitness(cfg=cfg, steps=list(steps), tensors=tensors, x=xs)


@dataclasses.dataclass
class FieldTables:
    """The stacked witness re-encoded as Montgomery tables (prover).

    ``tabs[name]`` is commitment slot `name`'s stacked table (``<name>_t``
    attributes resolve through it).  a_tabs[t][l] is the OPERAND of
    matmul l+1 (for a residual sum A1 + A2, computed, never committed),
    gz_tabs[t][l] is G_Z^{l+1}, w_mats[t][l] is W^{l+1} at its padded
    (in, out) shape; all padded to per-node power-of-two shapes."""
    tabs: Dict[str, torch.Tensor]
    x_tabs: torch.Tensor                 # (T*B, x_len), t-major
    a_tabs: List[List[torch.Tensor]]     # [t][l] (B, cpad_l)
    gz_tabs: List[List[torch.Tensor]]    # [t][l] (B, cpad_{l+1})
    w_mats: List[List[torch.Tensor]]     # [t][l] (ipad_{l+1}, opad_{l+1})

    def __getattr__(self, name: str):
        if name.endswith("_t"):
            try:
                return self.tabs[name[:-2]]
            except KeyError:
                pass
        raise AttributeError(name)


def _enc2d(tensor: torch.Tensor, rows_pad: int, cols_pad: int):
    return enc_tensor(pad2d(tensor, rows_pad, cols_pad)).reshape(
        rows_pad, cols_pad)


def build_field_tables(sw: StackedWitness) -> FieldTables:
    cfg = sw.cfg
    g = cfg.graph
    B = cfg.batch
    mms = [g.node_for_layer("qmatmul", l)
           for l in range(1, cfg.n_layers + 1)]
    operands = [g.node(mm.inputs[0]) for mm in mms]
    wshapes = [g.weight_shape(mm) for mm in mms]
    return FieldTables(
        tabs={name: enc_tensor(t) for name, t in sw.tensors.items()},
        x_tabs=enc_tensor(torch.stack(sw.x)).reshape(len(sw.x), -1),
        a_tabs=[[_enc2d(g.node_value(op.name, w), B, op.cols_pad)
                 for op in operands] for w in sw.steps],
        gz_tabs=[[_enc2d(gz, B, mms[l].cols_pad)
                  for l, gz in enumerate(w.gz)] for w in sw.steps],
        w_mats=[[_enc2d(m, *wshapes[l]) for l, m in enumerate(w.w)]
                for w in sw.steps])
