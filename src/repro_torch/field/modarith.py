"""Prime-field arithmetic on one 64-bit word per element.

The JAX package holds an element as four 16-bit limbs, because the TPU
has 32-bit integer lanes only.  An H100 multiplies 64-bit words
natively (`__umul64hi`), so here every field element is one
``torch.int64`` word holding the SAME Montgomery residue x * 2^64 mod m.
Both moduli are below 2^62, so every canonical value is a non-negative
int64 and `add` / `sub` with one conditional subtract never overflow.

`mont_mul` on a CUDA tensor is the hand-written modmul kernel
(`repro_torch.kernels.modmul`); on a CPU tensor it is `mont_mul_plain`,
the reference's radix-2^16 CIOS multiply written in int64 torch ops.
Every other product of the port goes through `mont_mul`.

Two fields are instantiated, as in the reference:

* ``FQ`` -- the proof/scalar field, q = 2^61 - 5283.
* ``FP`` -- the group field, p = 2q + 1; the commitment group is the
  order-q subgroup of quadratic residues of F_p^*.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

WORD = 16
WMASK = 0xFFFF
NLIMB = 4
MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Constants of one prime field in Montgomery form with R = 2^64."""

    name: str
    modulus: int
    nprime16: int          # -modulus^{-1} mod 2^16 (the reference's CIOS constant)
    r1: int                # 2^64 mod modulus  (Montgomery form of 1)
    r2: int                # 2^128 mod modulus (to_mont multiplier)

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @functools.cached_property
    def nprime64(self) -> int:
        """-modulus^{-1} mod 2^64, the one-word REDC constant."""
        return (-pow(self.modulus, -1, 1 << 64)) & MASK64

    @functools.cached_property
    def mod_limbs(self):
        return tuple((self.modulus >> (WORD * i)) & WMASK for i in range(NLIMB))

    @property
    def one(self) -> int:
        """Montgomery form of 1 (a canonical int)."""
        return self.r1


FQ = FieldSpec(
    name="Fq", modulus=2305843009213688669, nprime16=16139,
    r1=42264, r2=1786245696,
)
FP = FieldSpec(
    name="Fp", modulus=4611686018427377339, nprime16=397,
    r1=42260, r2=1785907600,
)
# Generator of the order-q subgroup (quadratic residues) of F_p^*.
GROUP_GEN = 4


# ---------------------------------------------------------------------------
# Representation changes (numpy, exact).
# ---------------------------------------------------------------------------

def limbs_to_words(limbs) -> np.ndarray:
    """(..., 4) uint32 16-bit limbs -> (...) int64 words (same residue)."""
    limbs = np.asarray(limbs).astype(np.uint64)
    words = np.zeros(limbs.shape[:-1], dtype=np.uint64)
    for j in range(NLIMB):
        words |= limbs[..., j] << np.uint64(WORD * j)
    return words.astype(np.int64)


def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> the reference's (4,) uint32 16-bit limb array."""
    return np.array([(x >> (WORD * i)) & WMASK for i in range(NLIMB)],
                    dtype=np.uint32)


def ints_to_limbs(xs) -> np.ndarray:
    """Python/numpy ints -> (..., 4) uint32 limb array: the low 64 bits
    of each value (two's complement for a negative one), as the
    reference packs them."""
    arr = np.asarray(xs, dtype=object)
    flat = arr.reshape(-1)
    out = np.empty(flat.shape + (NLIMB,), dtype=np.uint32)
    for j in range(NLIMB):
        out[:, j] = ((flat >> (WORD * j)) & WMASK).astype(np.uint32)
    return out.reshape(arr.shape + (NLIMB,))


def limbs_to_ints(limbs) -> np.ndarray:
    """(..., 4) uint32 limb array -> object array of python ints."""
    limbs = np.asarray(limbs)
    words = limbs_to_words(limbs).astype(np.uint64)
    return np.array([int(w) for w in words.reshape(-1)],
                    dtype=object).reshape(limbs.shape[:-1])


def words_to_limbs(words) -> np.ndarray:
    """(...) int64 words -> (..., 4) uint32 16-bit limbs."""
    u = np.asarray(words).astype(np.uint64)
    out = np.empty(u.shape + (NLIMB,), dtype=np.uint32)
    for j in range(NLIMB):
        out[..., j] = ((u >> np.uint64(WORD * j)) & np.uint64(WMASK)
                       ).astype(np.uint32)
    return out


# ---------------------------------------------------------------------------
# Elementwise arithmetic on int64 word tensors.
# ---------------------------------------------------------------------------

def _limb_split(x: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(0, WORD * NLIMB, WORD, device=x.device,
                          dtype=torch.int64)
    return (x.unsqueeze(-1) >> shifts) & WMASK


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-64 mod m in int64 torch ops (broadcasting).

    Radix-2^16 Montgomery multiplication with lazy carries: limb
    products are < 2^32 and no column ever exceeds 2^36, so int64 holds
    every partial sum.  The result is the canonical residue, equal to
    the reference's CIOS `mont_mul` and to the 64-bit REDC kernel."""
    a, b = torch.broadcast_tensors(a, b)
    al, bl = _limb_split(a), _limb_split(b)
    prod = al.unsqueeze(-1) * bl.unsqueeze(-2)               # (..., 4, 4)
    t = torch.zeros(a.shape + (2 * NLIMB + 1,), dtype=torch.int64,
                    device=a.device)
    for i in range(NLIMB):
        t[..., i:i + NLIMB] += prod[..., i, :]
    pl = torch.tensor(spec.mod_limbs, dtype=torch.int64, device=a.device)
    for i in range(NLIMB):
        mi = ((t[..., i] & WMASK) * spec.nprime16) & WMASK
        t[..., i:i + NLIMB] += mi.unsqueeze(-1) * pl
        t[..., i + 1] += t[..., i] >> WORD
    for k in range(NLIMB, 2 * NLIMB - 1):
        t[..., k + 1] += t[..., k] >> WORD
        t[..., k] &= WMASK
    u = (t[..., 4] | (t[..., 5] << 16) | (t[..., 6] << 32)
         | (t[..., 7] << 48))
    return torch.where(u >= spec.modulus, u - spec.modulus, u)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b) -> torch.Tensor:
    """Montgomery product a * b * 2^-64 mod m, broadcasting.

    ``b`` may be a tensor or a python int (a canonical value, passed to
    the kernel by value).  CUDA tensors run the modmul kernel; CPU
    tensors its plain version."""
    from repro_torch.kernels.modmul import modmul
    return modmul(spec, a, b)


def add(spec: FieldSpec, a: torch.Tensor, b) -> torch.Tensor:
    s = a + b
    return torch.where(s >= spec.modulus, s - spec.modulus, s)


def sub(spec: FieldSpec, a, b) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + spec.modulus, d)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Elementwise: one word per element, so no limb axis to reduce."""
    return a == 0


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a == b


def pow_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a python-int exponent in [0, 2^64): one powmod launch on a
    CUDA tensor (the exponent by value), host-side bits on a CPU one."""
    from repro_torch.kernels.powmod import powmod
    return powmod(spec, a, e)


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Field inverse via Fermat (a^(m-2)); a must be nonzero."""
    return pow_const(spec, a, spec.modulus - 2)


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverses of a flat vector.

    Fermat per element (one powmod launch on the card) instead of the
    reference's sequential prefix-product scan: every inverse is unique,
    so the values agree.  Like the reference's Montgomery trick, one
    zero entry zeroes the whole output."""
    if a.numel() == 0:
        return a
    out = inv(spec, a)
    return torch.where((a == 0).any(), torch.zeros_like(out), out)


def to_mont(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, x, spec.r2)


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, 1)


def fsum(spec: FieldSpec, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Field sum along ``dim`` with two integer reductions.

    Each canonical word splits into 32-bit halves; plain int64 sums of
    up to 2^31 halves cannot overflow, and the total is recombined as
    hi * 2^32 + lo mod m.  Exact, so equal to any summation order."""
    assert x.shape[dim] < (1 << 31)
    s_lo = (x & 0xFFFFFFFF).sum(dim)
    s_hi = (x >> 32).sum(dim)
    hi = mont_mul(spec, torch.remainder(s_hi, spec.modulus),
                  (1 << 32) * pow(2, 64, spec.modulus) % spec.modulus)
    return add(spec, hi, torch.remainder(s_lo, spec.modulus))


# ---------------------------------------------------------------------------
# Host helpers: python ints <-> Montgomery words.
# ---------------------------------------------------------------------------

def encode_int(spec: FieldSpec, x: int) -> int:
    """Python int (possibly negative) -> Montgomery form, canonical int."""
    return (x * pow(2, 64, spec.modulus)) % spec.modulus


def encode_ints(spec: FieldSpec, xs, device="cpu") -> torch.Tensor:
    """Python/numpy ints (any size, any sign) -> int64 Montgomery tensor."""
    arr = np.asarray(xs, dtype=object)
    r = pow(2, 64, spec.modulus)
    vals = (arr * r) % spec.modulus if arr.size else arr
    return torch.tensor(np.asarray(vals, dtype=np.int64).reshape(arr.shape),
                        dtype=torch.int64, device=device)


def encode_i64(spec: FieldSpec, xs: torch.Tensor) -> torch.Tensor:
    """int64 tensor (any sign) -> Montgomery form, on its own device."""
    return to_mont(spec, torch.remainder(xs.to(torch.int64), spec.modulus))


def decode(spec: FieldSpec, a: torch.Tensor) -> np.ndarray:
    """Montgomery tensor -> object array of canonical python ints (host)."""
    std = from_mont(spec, a).cpu().numpy()
    return np.array(std.tolist(), dtype=object).reshape(std.shape)


def decode_centered(spec: FieldSpec, a: torch.Tensor) -> np.ndarray:
    """Decode to signed representatives in (-m/2, m/2]."""
    vals = decode(spec, a)
    m = spec.modulus
    flat = vals.reshape(-1)
    for i in range(flat.shape[0]):
        if flat[i] > m // 2:
            flat[i] -= m
    return vals


def rand_elements(spec: FieldSpec, rng: np.random.Generator, shape,
                  device="cpu") -> torch.Tensor:
    """Uniform field elements in Montgomery form, drawn on the host in
    the reference's order (one ``rng.integers`` per element)."""
    n = int(np.prod(shape)) if shape else 1
    vals = [int(rng.integers(0, spec.modulus, dtype=np.uint64)) % spec.modulus
            for _ in range(n)]
    return encode_ints(spec, np.array(vals, dtype=object).reshape(shape),
                       device=device)


def hash_to_int(data: bytes, modulus: int) -> int:
    h = hashlib.sha256(data).digest()
    return int.from_bytes(h, "little") % modulus
