"""Wrapper of the generator-derivation kernel (`generators.cu`) and its
plain version, the reference's hashlib loop.

Generator i of a label is max(SHA-256(label || i as 8 little-endian
bytes) read little-endian mod P, 2), squared mod P and lifted to
Montgomery form.  A CPU device takes the hashlib loop; a CUDA device
launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.field.modarith import FP, hash_to_int
from repro_torch.kernels import _build

#: one SHA-256 block holds the label, the 8 index bytes, the 0x80
#: terminator and the 8-byte length
MAX_LABEL_BYTES = 55 - 8


def derive_plain(label: bytes, start: int, n: int, device) -> torch.Tensor:
    p = FP.modulus
    r = pow(2, 64, p)
    gm = []
    for i in range(start, start + n):
        t = max(hash_to_int(label + i.to_bytes(8, "little"), p), 2)
        gm.append(t * t % p * r % p)
    return torch.tensor(gm, dtype=torch.int64, device=device)


def _block_template(label: bytes) -> np.ndarray:
    """The padded SHA-256 block of label || 8 zero bytes, as 16
    big-endian 32-bit words (stored as int32 bit patterns)."""
    msg_len = len(label) + 8
    block = bytearray(64)
    block[:len(label)] = label
    block[msg_len] = 0x80
    block[56:] = (8 * msg_len).to_bytes(8, "big")
    words = [int.from_bytes(block[4 * k: 4 * k + 4], "big")
             for k in range(16)]
    return np.array(words, dtype=np.uint32).view(np.int32)


def derive(label: bytes, start: int, n: int, device) -> torch.Tensor:
    """Generators start .. start+n-1 of ``label``: (n,) int64 Montgomery
    words of the order-q subgroup."""
    if len(label) > MAX_LABEL_BYTES:
        raise ValueError(f"generator label of {len(label)} bytes does not "
                         f"fit one SHA-256 block (max {MAX_LABEL_BYTES})")
    device = torch.device(device)
    if device.type == "cpu":
        return derive_plain(label, start, n, device)
    if device.type != "cuda":
        raise ValueError(f"derive: expected a CUDA or CPU device, got "
                         f"{device}")
    block = torch.from_numpy(_block_template(label)).to(device)
    out = torch.empty(n, dtype=torch.int64, device=device)
    err = _build.lib("generators").zk_derive_generators(
        block.data_ptr(), len(label), start, n, out.data_ptr(), FP.modulus,
        FP.nprime64, FP.r2, _build.stream_handle(device))
    _build.check(err, "derive_generators")
    derive.launches += 1
    return out


derive.launches = 0
