"""Ambient sharding hints for intermediate activations (the reference's
`repro.distributed.hints`).

Model code cannot know the mesh, but a handful of intermediates (MoE
dispatch buffers above all) must carry explicit placements, and a few
reshapes of sharded activations need one before DTensor can propagate
through them.  The launcher calls ``set_axes`` before the step; model
code calls ``constrain`` with symbolic axes ("BATCH" / "MODEL") that
resolve against the ambient mesh, and the call is a no-op on a plain
tensor or with no axes set (one device, the smoke tests).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import placements
from repro_torch.tree import tree_map

_AXES: dict = {"batch": None, "model": None, "sizes": {}, "mesh": None}


def set_axes(batch_axes: Optional[Tuple[str, ...]], model_axis: Optional[str],
             sizes: Optional[dict] = None, mesh=None) -> None:
    _AXES["batch"] = tuple(batch_axes) if batch_axes else None
    _AXES["model"] = model_axis
    _AXES["sizes"] = dict(sizes or {})
    _AXES["mesh"] = mesh


def clear() -> None:
    set_axes(None, None, None, None)


def mesh():
    """The ambient device mesh (None outside a configured launch)."""
    return _AXES["mesh"]


def batch_axis_names() -> Optional[Tuple[str, ...]]:
    return _AXES["batch"]


def model_axis() -> Optional[str]:
    return _AXES["model"]


def axis_size(which: str) -> int:
    if which == "BATCH":
        return max(1, int(_AXES["sizes"].get("batch", 1)))
    return max(1, int(_AXES["sizes"].get("model", 1)))


def resolve(shape, spec: Sequence) -> tuple:
    """The mesh spec of ``spec`` for a tensor of ``shape``: "BATCH" and
    "MODEL" become the ambient axes where the dim divides their size,
    None elsewhere (the reference's fallback)."""
    dims = []
    for i, s in enumerate(spec):
        if s == "BATCH" and _AXES["batch"]:
            dims.append(_AXES["batch"] if shape[i] % axis_size("BATCH") == 0
                        else None)
        elif s == "MODEL" and _AXES["model"]:
            dims.append(_AXES["model"] if shape[i] % axis_size("MODEL") == 0
                        else None)
        else:
            dims.append(None)
    return tuple(dims)


def constrain(x, spec: Sequence):
    """spec entries: "BATCH" | "MODEL" | None.  A DTensor is
    redistributed to the resolved placements (a failed redistribute
    raises); a plain tensor, or any tensor with no axes set, is
    returned as it is."""
    if _AXES["batch"] is None and _AXES["model"] is None:
        return x
    if not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, resolve(x.shape, spec))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gather_weights(tree):
    """Each DTensor of ``tree`` replicated over the batch axes: FSDP's
    all-gather of a layer's weights before it runs (the gradient goes
    back reduce-scattered).  Without it DTensor's matmul strategies
    may gather the activations over the batch instead, which keeps a
    device's memory from shrinking with the batch shard.  A no-op with
    no axes set and on plain tensors."""
    bax = set(_AXES["batch"] or ())
    if not bax:
        return tree

    def one(t):
        if not isinstance(t, DTensor):
            return t
        want = tuple(Replicate() if name in bax else p for name, p in
                     zip(t.device_mesh.mesh_dim_names, t.placements))
        if want == tuple(t.placements):
            return t
        return t.redistribute(t.device_mesh, want)
    return tree_map(one, tree)
