"""Atomic checkpointing with restart support.

Layout:  <dir>/step_<n>/
             manifest.json            tree structure + shapes + dtypes
             <leaf-id>.npy            one file per tree leaf
             _COMPLETE                commit marker (atomicity)

The layout, the leaf names and the commit protocol are the reference's
(`repro.train.checkpoint`), so either package restores the other's
checkpoints.  A tree is nested dicts (flattened in sorted key order),
lists and tuples; its leaves are tensors, numpy arrays or scalars.
Leaves are written from host copies; `restore` places each leaf on an
explicit ``device`` (the reference re-shards with ``jax.device_put``
instead).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_names, tree_unflatten


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


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, state) -> str:
    """Atomic checkpoint write; returns the committed directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in tree_leaves_with_names(state):
        arr = _host(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {"shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep=3)
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


def restore(ckpt_dir: str, step: int, state_template, device=None):
    """Load into the structure of ``state_template``, every leaf a tensor
    on ``device`` (None: the template leaf's device when it is a tensor,
    else the card)."""
    from repro_torch._device import resolve_device

    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    out = []
    for name, tmpl in tree_leaves_with_names(state_template):
        arr = np.load(os.path.join(d, name + ".npy"))
        assert tuple(arr.shape) == tuple(np.shape(tmpl)), (name, arr.shape)
        if device is not None:
            dev = resolve_device(device)
        elif isinstance(tmpl, torch.Tensor):
            dev = tmpl.device
        else:
            dev = resolve_device(None)
        out.append(torch.as_tensor(arr, device=dev))
    return tree_unflatten(state_template, out)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "_COMPLETE")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
