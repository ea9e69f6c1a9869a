"""Device meshes on `torch.distributed` (the reference's
`repro.launch.mesh`).

Functions only, never module-level meshes: importing this module
touches no process-group state, because the dry run starts a fake
group of 256 or 512 ranks while every other entry point sees the world
it was launched into.  A mesh's device type follows the world's
backend: ``cuda`` under NCCL, ``cpu`` under gloo and the dry run's fake
group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def init_world(backend: str) -> None:
    """A world of one rank (an in-process store, no port) unless a
    process group exists already: a one-device run outside torchrun."""
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(shape, axes) -> DeviceMesh:
    """A DeviceMesh of ``shape`` named ``axes`` over the first ranks of
    the world; a world with fewer ranks is refused."""
    need = math.prod(shape)
    found = dist.get_world_size() if dist.is_initialized() else 1
    if found < need or not dist.is_initialized():
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {need} devices, found {found}; "
            "run under launch/dryrun.py (which starts a fake process group "
            "of that size) or under torchrun with that world size")
    ranks = torch.arange(need).reshape(tuple(shape))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 chips per pod; (2,16,16) = 512 chips across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_debug_mesh(shape=(1, 1), axes=("data", "model")) -> DeviceMesh:
    """Single-device mesh for tests; starts a gloo world of one when no
    process group exists."""
    init_world("gloo")
    return make_mesh(shape, axes)


def batch_axes(mesh) -> tuple:
    """The mesh axes the global batch is sharded over."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
