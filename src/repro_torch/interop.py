"""Carry values across from the reference (JAX) package.

The reference keeps a field or group element as a ``(..., 4)`` uint32
array of 16-bit limbs; the port as one int64 word with the same
Montgomery residue.  `from_reference` repacks limb arrays and turns the
reference's numpy ``StepWitness`` into the port's (int64 tensors on a
device).  `params_from_reference` carries a float parameter tree
(nested dicts of numpy arrays, as ``jax.device_get`` gives the
reference's params) onto a device, and `params_to_reference` takes a
port tree back to numpy.
Nothing here imports the reference: its objects are read by attribute.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.quantfc import QuantConfig, StepWitness
from repro_torch.field.modarith import limbs_to_words, words_to_limbs
from repro_torch.tree import tree_map

__all__ = ["from_reference", "to_limbs", "limbs_to_words", "words_to_limbs",
           "params_from_reference", "params_to_reference"]

_LIST_FIELDS = ("w", "z", "zpp", "b", "rz", "a", "gz", "ga", "gap", "rga",
                "gw")


def from_reference(obj, device=None):
    """Reference value -> port value on ``device`` (default: the card).

    * a ``(..., 4)`` uint32 limb array -> int64 word tensor (...);
    * a reference ``StepWitness`` (numpy int64 fields) -> the port's
      `StepWitness`;
    * a list/tuple of either -> a list.
    """
    dev = resolve_device(device)
    if isinstance(obj, (list, tuple)):
        return [from_reference(o, dev) for o in obj]
    if hasattr(obj, "gw") and hasattr(obj, "cfg"):
        def t(v):
            return torch.as_tensor(np.asarray(v, dtype=np.int64), device=dev)
        return StepWitness(
            cfg=QuantConfig(q_bits=obj.cfg.q_bits, r_bits=obj.cfg.r_bits),
            x=t(obj.x), y=t(obj.y),
            **{f: [t(v) for v in getattr(obj, f)] for f in _LIST_FIELDS},
            skips=dict(obj.skips))
    arr = np.asarray(obj)
    if arr.dtype == np.uint32 and arr.shape[-1:] == (4,):
        return torch.as_tensor(limbs_to_words(arr), device=dev)
    raise TypeError(f"from_reference: unsupported value {type(obj)!r}")


def to_limbs(words: torch.Tensor) -> np.ndarray:
    """Port word tensor -> the reference's (..., 4) uint32 limb array."""
    return words_to_limbs(words.detach().cpu().numpy())


def params_from_reference(tree, device=None, dtype=None):
    """The reference's parameter tree (nested dicts of host arrays, the
    stacked layer axis leading) -> the port's tree of tensors on
    ``device`` (default: the card), with the same keys.  Float leaves
    keep their dtype unless ``dtype`` is given; bfloat16 host arrays
    (``ml_dtypes``) arrive as float32 bits widened exactly."""
    dev = resolve_device(device)

    def one(leaf):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            t = torch.as_tensor(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))         # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)
    return tree_map(one, tree)


def params_to_reference(tree):
    """Inverse of `params_from_reference`: host numpy arrays (bfloat16
    leaves widened to float32)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(one, tree)
