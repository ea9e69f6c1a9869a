"""Atomic checkpointing with restart support.

Layout:  <dir>/step_<n>/
             manifest.json            tree structure + shapes + dtypes
             <leaf-id>.npy            one file per tree leaf
             _COMPLETE                commit marker (atomicity)

The layout, the leaf names and the commit protocol are the reference's
(`repro.train.checkpoint`), so either package restores the other's
checkpoints.  A tree is nested dicts (flattened in sorted key order),
lists and tuples; its leaves are tensors (DTensors too), numpy arrays
or scalars.  Leaves are written from host copies of the whole tensor:
a DTensor is gathered on every rank (``full_tensor``) and rank 0
writes.  A bfloat16 leaf is written as the reference writes it through
``ml_dtypes``: its raw 2-byte words in a ``'<V2'`` ``.npy`` file, with
``"dtype": "bfloat16"`` in the manifest.  `restore` places each leaf on
an explicit ``device``, or distributes it over the current mesh by the
given shardings, which is the elastic path: a checkpoint written on
one mesh resumes on any other (the reference re-shards with
``jax.device_put``).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import (tree_leaves, tree_leaves_with_names,
                              tree_unflatten)


class StorageError(OSError):
    """A durable-write failure (full disk, IO error, permission): the
    typed form every `atomic_write_bytes` caller in the proving service
    sees instead of a raw `OSError`.  The write is all-or-nothing — on
    failure the temp file is removed, so a full disk leaves no orphan
    ``*.tmp`` turds and the target path is never half-written.  Service
    policy on catching it: mark the window FAILED (worker side) or
    retry with backoff / drop the window per the backpressure policy
    (submit side) — never crash the worker loop."""

    @property
    def is_enospc(self) -> bool:
        import errno
        return self.errno == errno.ENOSPC


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Single-file form of the checkpoint commit pattern (tmp + rename):
    readers never observe a torn write, and a crash mid-write leaves only
    a ``*.tmp.<pid>`` turd, never a half-valid ``path``.  Used by the
    crash-safe prover service for journal segments, proof files, and
    vk.bin (`launch/serve.py`).

    Any `OSError` during the write (ENOSPC on a full disk being the
    canonical case) is re-raised as a typed `StorageError` AFTER the
    temp file has been cleaned up: callers get a precise failure class
    and the directory stays free of orphan temp files."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as exc:
        try:
            os.remove(tmp)
        except OSError:
            pass
        if isinstance(exc, StorageError):
            raise
        raise StorageError(exc.errno or 0,
                           f"durable write of {path!r} failed: "
                           f"{exc.strerror or exc}") from exc


def _host(leaf):
    """(host numpy array, manifest dtype) of a leaf; a bfloat16 tensor
    becomes its raw 2-byte words."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy(), "bfloat16"
        arr = leaf.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # the bytes np.save writes for an ml_dtypes bfloat16 array
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, state) -> str:
    """Atomic checkpoint write; returns the committed directory.  Every
    rank of a process group calls it (DTensor leaves are gathered);
    rank 0 writes, and the others wait for the commit."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = _writer()
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in tree_leaves_with_names(state):
        arr, dtype = _host(leaf)
        if writer:
            _save_npy(os.path.join(tmp, name + ".npy"), arr, dtype)
        manifest["leaves"][name] = {"shape": list(arr.shape),
                                    "dtype": dtype}
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep=3)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "_COMPLETE")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, state_template, shardings=None,
            device=None):
    """Load into the structure of ``state_template``.  With
    ``shardings`` (a tree of `repro_torch.distributed.sharding`
    NamedShardings) every leaf is distributed over its mesh from
    ``device``; otherwise each is a tensor on ``device`` (None: the
    template leaf's device when it is a tensor, else the card)."""
    from repro_torch._device import resolve_device

    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["leaves"].items()}
    shard_leaves = (tree_leaves(shardings) if shardings is not None
                    else None)
    out = []
    for i, (name, tmpl) in enumerate(tree_leaves_with_names(state_template)):
        arr = np.load(os.path.join(d, name + ".npy"))
        shape = (tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor)
                 else np.shape(tmpl))
        assert tuple(arr.shape) == shape, (name, arr.shape)
        if device is not None:
            dev = resolve_device(device)
        elif isinstance(tmpl, DTensor):
            dev = tmpl.to_local().device
        elif isinstance(tmpl, torch.Tensor):
            dev = tmpl.device
        else:
            dev = resolve_device(None)
        if dtypes.get(name) == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        else:
            t = torch.as_tensor(arr, device=dev)
        if shard_leaves is not None:
            sh = shard_leaves[i]
            t = distribute_tensor(t, sh.mesh, sh.placements)
        out.append(t)
    return tree_unflatten(state_template, out)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "_COMPLETE")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
