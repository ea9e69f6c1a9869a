"""Sharding rules: map every parameter / batch / cache leaf to a
`PartitionSpec` over the production mesh (the reference's
`repro.distributed.sharding`, rule for rule).

Strategy (MaxText-style logical rules, resolved per tensor):
  * 'model' (TP): attention heads / FFN hidden / vocab / expert axis
  * 'data' (DP + optional FSDP): batch; weight fan-in dim when cfg.fsdp
  * 'pod' (multi-pod DP): outermost batch axis only -- gradient all-reduce
    crosses pods once per step, everything else stays intra-pod.

Every rule is guarded by divisibility; an indivisible dim falls back to
replication, so any (arch x mesh) pair has a placement.

The rules read only the mesh's axis names and sizes (``mesh_dim_names``
and ``shape``, as a `DeviceMesh` has them), so the dry run and the
tests apply them without devices.  `placements` turns a spec into
DTensor placements, and a `NamedSharding` carries both to
``distribute_tensor``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map_with_path

STACKED_KEYS = ("blocks", "dense_blocks", "enc", "dec")
NORM_KEYS = ("ln", "ln1", "ln2", "ln3", "norm", "final_norm", "q_norm",
             "k_norm", "ckv_norm", "a_log", "d_skip", "dt_bias")


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names (the dim is
    split over each, major to minor), or None (replicated); dims past
    the end are replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _axes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axsize(mesh, name: str) -> int:
    return _axes(mesh).get(name, 1)


def _fits(dim: int, mesh, name) -> bool:
    if name is None:
        return True
    return dim % _axsize(mesh, name) == 0 and _axsize(mesh, name) > 1


def _ax(dim: int, mesh, name):
    return name if _fits(dim, mesh, name) else None


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            if name is not None:
                out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return tuple(out)


def local_shape(shape, mesh, spec) -> tuple:
    """Each device's shard of a tensor of ``shape`` placed by ``spec``
    (the rules place only dims that their axes divide)."""
    out = list(shape)
    sizes = _axes(mesh)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[d] //= sizes[name]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def param_spec(cfg: ModelConfig, mesh, path: Tuple[str, ...],
               shape: Tuple[int, ...]) -> PartitionSpec:
    keys = list(path)
    name = keys[-1]
    fsdp = "data" if cfg.fsdp else None
    stacked = any(k in STACKED_KEYS for k in keys)
    off = 1 if stacked else 0
    dims: list = [None] * len(shape)

    def set_ax(i, ax_name):
        if 0 <= i < len(shape):
            dims[i] = _ax(shape[i], mesh, ax_name)

    if name in NORM_KEYS or len(shape) <= 1 + off:
        pass
    elif name == "embed":
        set_ax(0, "model"); set_ax(1, fsdp)
    elif name == "head":
        set_ax(0, fsdp); set_ax(1, "model")
    elif "moe" in keys and name in ("wi", "wg"):
        # (L, E, d, f)
        e_i, d_i, f_i = off, off + 1, off + 2
        if _fits(shape[e_i], mesh, "model"):
            set_ax(e_i, "model"); set_ax(d_i, fsdp)
        else:
            set_ax(d_i, fsdp); set_ax(f_i, "model")
    elif "moe" in keys and name == "wo":
        e_i, f_i, d_i = off, off + 1, off + 2
        if _fits(shape[e_i], mesh, "model"):
            set_ax(e_i, "model"); set_ax(d_i, fsdp)
        else:
            set_ax(f_i, "model"); set_ax(d_i, fsdp)
    elif name == "router":
        set_ax(off, fsdp)
    elif name in ("wq", "wk", "wv", "wi", "wg", "in_proj", "wuk", "wuv"):
        set_ax(off, fsdp); set_ax(off + 1, "model")
    elif name in ("wo", "out_proj"):
        set_ax(off, "model"); set_ax(off + 1, fsdp)
    elif name in ("wdkv", "wkpe"):
        set_ax(off, fsdp)
    elif name == "conv":
        set_ax(off + 1, "model")
    return P(*dims)


def param_shardings(cfg: ModelConfig, mesh, params_tree):
    def assign(path, leaf):
        return NamedSharding(mesh, param_spec(cfg, mesh, path,
                                              tuple(leaf.shape)))
    return tree_map_with_path(assign, params_tree)


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def _batch_ax(mesh, b: int):
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    size = 1
    for a in axes:
        size *= _axsize(mesh, a)
    return axes if (axes and b % size == 0) else None


def batch_shardings(cfg: ModelConfig, mesh, batch_tree):
    def assign(path, leaf):
        name = path[-1]
        if name == "positions3":             # (3, B, S)
            bax = _batch_ax(mesh, leaf.shape[1])
            spec = P(None, bax)
        else:                                # leading batch dim
            bax = _batch_ax(mesh, leaf.shape[0])
            if name in ("embeds", "frames") and len(leaf.shape) == 3:
                spec = P(bax, None, _ax(leaf.shape[2], mesh, "model"))
            else:
                spec = P(bax)
        return NamedSharding(mesh, spec)
    return tree_map_with_path(assign, batch_tree)


def cache_shardings(cfg: ModelConfig, mesh, cache_tree):
    def assign(path, leaf):
        name = path[-1]
        shape = leaf.shape
        if name in ("k", "v", "xk", "xv"):    # (L, B, S, KV, Dh)
            bax = _batch_ax(mesh, shape[1])
            kv_ax = _ax(shape[3], mesh, "model")
            dh_ax = None if kv_ax else _ax(shape[4], mesh, "model")
            return NamedSharding(mesh, P(None, bax, None, kv_ax, dh_ax))
        if name == "ckv":                     # (L, B, S, r)
            bax = _batch_ax(mesh, shape[1])
            return NamedSharding(mesh, P(None, bax, None,
                                         _ax(shape[3], mesh, "model")))
        if name == "kpe":                     # (L, B, S, dr)
            bax = _batch_ax(mesh, shape[1])
            return NamedSharding(mesh, P(None, bax, None, None))
        if name == "state":                   # (L, B, H, P, N)
            bax = _batch_ax(mesh, shape[1])
            return NamedSharding(mesh, P(None, bax,
                                         _ax(shape[2], mesh, "model"),
                                         None, None))
        if name == "conv":                    # (L, B, K, ch)
            bax = _batch_ax(mesh, shape[1])
            return NamedSharding(mesh, P(None, bax, None,
                                         _ax(shape[3], mesh, "model")))
        return NamedSharding(mesh, P())
    return tree_map_with_path(assign, cache_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
