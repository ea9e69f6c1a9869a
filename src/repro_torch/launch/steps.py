"""Train / prefill / decode steps (the reference's `repro.launch.steps`).

Two halves.  For provable integer-SGD families: the layer-graph
pipeline config of a model config, the exact integer SGD step that
yields each batch's witness, and the hook that proves (and verifies)
one aggregated proof per window.  For the LM families: the AdamW train
step, the prefill and decode steps and the state's shapes, and on a
device mesh the state's placements (`state_shardings`) and the dry
run's cell (`lower_cell`): the step run once on DTensors of meta
tensors, metered per device.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

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
    if isinstance(loss, DTensor):           # the mean's sum over devices
        loss = loss.redistribute(
            placements=[Replicate()] * loss.device_mesh.ndim)
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


# ---------------------------------------------------------------------------
# Device mesh: state placement, hints and the dry run's cell
# ---------------------------------------------------------------------------

def state_shardings(cfg, mesh, state_tree):
    from repro_torch.distributed import sharding as shard_rules

    p_sh = shard_rules.param_shardings(cfg, mesh, state_tree["params"])
    mu_sh = shard_rules.param_shardings(cfg, mesh, state_tree["opt"]["mu"])
    nu_sh = shard_rules.param_shardings(cfg, mesh, state_tree["opt"]["nu"])
    return {"params": p_sh,
            "opt": {"mu": mu_sh, "nu": nu_sh,
                    "step": shard_rules.replicated(mesh)}}


def set_mesh_hints(mesh) -> None:
    """Point the model's sharding hints at ``mesh``: the batch over its
    ``pod`` / ``data`` axes, the model axis over ``model``."""
    from repro_torch.distributed import hints
    from repro_torch.launch.mesh import batch_axes

    names = dict(zip(mesh.mesh_dim_names, mesh.shape))
    bax = batch_axes(mesh)
    sizes = {"batch": math.prod(names[a] for a in bax),
             "model": names.get("model", 1)}
    hints.set_axes(bax, "model" if "model" in names else None, sizes,
                   mesh=mesh)


def place(tree, shardings):
    """Each tensor of ``tree`` distributed (`distribute_tensor`, from rank
    0) by the `NamedSharding` at the same place in ``shardings``."""
    from torch.distributed.tensor import distribute_tensor

    return tree_unflatten(tree, [
        distribute_tensor(t, sh.mesh, sh.placements)
        for t, sh in zip(tree_leaves(tree), tree_leaves(shardings))])


def redistribute_to(tree, shardings):
    """DTensor leaves redistributed to ``shardings`` where they differ
    (the reference's ``out_shardings``)."""
    def one(t, sh):
        if tuple(t.placements) == sh.placements:
            return t
        return t.redistribute(sh.mesh, sh.placements)
    return tree_unflatten(tree, [one(t, sh) for t, sh in
                                 zip(tree_leaves(tree), tree_leaves(shardings))])


def local_bytes(tree) -> int:
    """Bytes of each device's share of ``tree``: a DTensor counts its
    local shard, a tensor its whole self."""
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


class StepMeter(TorchDispatchMode):
    """Per-device counts of one step, from the operators each device
    runs (DTensor ops are let through to their local operators and
    collectives, as ``CommDebugMode`` does): flops by
    `torch.utils.flop_counter`'s formulas; bytes every operator reads
    and writes (views excluded, no fusion); the operand bytes of each
    functional collective, by kind; and the peak of live local bytes,
    every storage counted from the operator that made it until it is
    freed (``track`` adds tensors made before the step).

    The step runs on ``meta`` tensors.  DTensor derives each new op's
    global output shape by running it once on global-shape fake
    tensors: those runs do no device's work and are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {k: 0 for k in _COLLECTIVES.values()}
        self.collectives["collective-permute"] = 0
        self.live = 0
        self.peak = 0
        self._refs = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n):
            self.live -= n
            self._refs.pop(key, None)
        self._refs[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if any(isinstance(a, FakeTensor) for a in ins + outs):
            return out                        # DTensor's shape propagation
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                self.collectives[kind] += sum(a.nbytes for a in ins)
        elif packet in self._flops:
            self.flops += self._flops[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes_accessed += sum(t.nbytes for t in ins + outs)
        for o in outs:
            self.track(o)
        return out


@dataclasses.dataclass
class Compiled:
    """What one metered run of a cell's step gives, per device."""
    flops: float
    bytes_accessed: float
    collectives: dict
    argument_bytes: int
    output_bytes: int
    peak_live_bytes: int


@dataclasses.dataclass
class Lowered:
    """A cell's step and its inputs, DTensors whose shards are ``meta``
    tensors placed by the sharding rules; ``compile()`` runs the step
    once under a `StepMeter` (the reference's ``jax.stages.Lowered``)."""
    fn: object
    args: tuple

    def compile(self) -> Compiled:
        from torch.distributed.tensor.experimental import \
            implicit_replication

        meter = StepMeter()
        for t in tree_leaves(list(self.args)):
            if isinstance(t, torch.Tensor):
                meter.track(t.to_local() if isinstance(t, DTensor) else t)
        with meter, implicit_replication():
            out = self.fn(*self.args)
        return Compiled(flops=float(meter.flops),
                        bytes_accessed=float(meter.bytes_accessed),
                        collectives=dict(meter.collectives),
                        argument_bytes=local_bytes(list(self.args)),
                        output_bytes=local_bytes(out),
                        peak_live_bytes=meter.peak)


def meta_placed(tree, shardings):
    """DTensors with the shapes and dtypes of ``tree``'s leaves whose
    shards are ``meta`` tensors, each device's shard as ``shardings``
    places it."""
    from repro_torch.distributed.sharding import local_shape

    def one(t, sh):
        loc = torch.empty(local_shape(t.shape, sh.mesh, sh.spec),
                          dtype=t.dtype, device="meta")
        return DTensor.from_local(loc, sh.mesh, sh.placements,
                                  run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())
    return tree_unflatten(tree, [one(t, sh) for t, sh in
                                 zip(tree_leaves(tree), tree_leaves(shardings))])


def lower_train(cfg, mesh, seq: int, batch: int, opt_cfg=None) -> Lowered:
    """The train step of ``cfg`` at ``seq`` x ``batch`` on ``mesh``."""
    from repro_torch.distributed import sharding as shard_rules
    from repro_torch.launch import specs as specs_mod

    if opt_cfg is None:
        opt_cfg = default_opt_cfg(cfg)
    set_mesh_hints(mesh)
    st_spec = state_specs(cfg, opt_cfg)
    st_shard = state_shardings(cfg, mesh, st_spec)
    b_spec = specs_mod.train_batch_specs(cfg, seq, batch)
    b_shard = shard_rules.batch_shardings(cfg, mesh, b_spec)
    step = build_train_step(cfg, opt_cfg)

    def run(state, batch):
        new_state, metrics = step(state, batch)
        return redistribute_to(new_state, st_shard), metrics
    return Lowered(run, (meta_placed(st_spec, st_shard),
                         meta_placed(b_spec, b_shard)))


def lower_cell(cfg, mesh, shape_name: str, opt_cfg=None) -> Lowered:
    """The step of one (arch x shape x mesh) cell, ready to ``compile()``
    (the reference's ``jax.stages.Lowered``)."""
    from repro_torch.distributed import sharding as shard_rules
    from repro_torch.launch import specs as specs_mod

    seq, batch, kind = specs_mod.SHAPE_GRID[shape_name]
    if kind == "train":
        return lower_train(cfg, mesh, seq, batch, opt_cfg)
    set_mesh_hints(mesh)
    spec = specs_mod.input_specs(cfg, shape_name)
    p_spec = specs_mod.param_specs(cfg)
    params = meta_placed(p_spec, shard_rules.param_shardings(cfg, mesh,
                                                             p_spec))
    if kind == "prefill":
        b_shard = shard_rules.batch_shardings(cfg, mesh, spec["batch"])
        return Lowered(build_prefill_step(cfg), (
            params, meta_placed(spec["batch"], b_shard)))

    c_shard = shard_rules.cache_shardings(cfg, mesh, spec["cache"])
    step = build_decode_step(cfg)
    pos = seq - 1          # the last slot: every cache position attended
    if cfg.family == "vlm":
        toks = {"embeds": spec["token"], "positions3": spec["positions3"]}
    else:
        toks = {"tokens": spec["token"]}
    toks = meta_placed(toks, shard_rules.batch_shardings(cfg, mesh, toks))

    def run(params, cache, token, positions3=None):
        logits, new_cache = step(params, cache, token, pos, positions3)
        return logits, redistribute_to(new_cache, c_shard)

    cache = meta_placed(spec["cache"], c_shard)
    if cfg.family == "vlm":
        args = (params, cache, toks["embeds"], toks["positions3"])
    else:
        args = (params, cache, toks["tokens"])
    return Lowered(run, args)
