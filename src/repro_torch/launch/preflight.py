"""Preflight witness validation: reject malformed witnesses BEFORE they
are journaled.

The checks, their order, their error classes and their messages are the
reference's (`repro.launch.preflight`), on the port's `StepWitness` of
int64 tensors: a witness on the card is checked on the card (one
``aminmax`` per tensor, ``torch.equal`` for the decompositions), and no
host copy of a tensor is made.

The write-ahead journal makes every submitted witness durable —
which means a malformed witness from a bad client would be durable too:
it would replay on every restart, fail the window's prove attempts
forever, and burn pool capacity retrying garbage.  The gateway therefore
validates each witness against the tenant's ProvingKey geometry at
``submit()`` time and rejects with a TYPED error before any byte hits
disk, so a bad client poisons nothing (not the journal, not the queue,
not the worker pool).

Checks, in order (cheapest first), each with its own error class so
clients can distinguish "fix your config" from "fix your tensors":

* `WitnessQuantError`    — the witness was built under a different
  quantization (q_bits / r_bits) than the key.
* `WitnessShapeError`    — layer count, widths, batch, or any per-tensor
  shape disagrees with the compiled graph geometry.
* `WitnessDtypeError`    — a tensor is not int64 (the exact-integer
  carrier every relation is proved over; narrower ints would overflow
  the 2^{2R}-scale products silently).
* `WitnessTopologyError` — the residual skip topology the witness was
  computed under differs from the graph's.
* `WitnessRangeError`    — a committed tensor violates its quantization
  range or decomposition: Z'' outside [0, 2^{Q-1}), B not a bit plane,
  a rescale remainder outside [0, 2^R), or the eq. (3)/(5) rescale
  decompositions not holding elementwise.  (A witness that passes these
  can still fail to prove — preflight is a cheap filter, not the
  soundness argument — but one that fails them provably cannot.)
* `WitnessStepError`     — the client-declared step index breaks the
  tenant's monotonic step sequence (raised by the gateway's ``submit``,
  which owns the step counter; exported here with the family).

All of them subclass `WitnessValidationError` (a `ValueError`), so
"reject anything malformed" is one except clause.
"""
from __future__ import annotations

from typing import Optional

import torch


class WitnessValidationError(ValueError):
    """A submitted witness failed preflight validation (never journaled)."""


class WitnessQuantError(WitnessValidationError):
    """Witness quantization config != key quantization config."""


class WitnessShapeError(WitnessValidationError):
    """A tensor shape / layer count disagrees with the key geometry."""


class WitnessDtypeError(WitnessValidationError):
    """A witness tensor is not int64."""


class WitnessTopologyError(WitnessValidationError):
    """The witness residual-skip topology differs from the graph's."""


class WitnessRangeError(WitnessValidationError):
    """A tensor violates its quantization range or decomposition."""


class WitnessStepError(WitnessValidationError):
    """A declared step index breaks the tenant's monotonic sequence."""


def _require_int64(name: str, a: torch.Tensor) -> None:
    if a.dtype != torch.int64:
        dtype = str(a.dtype).replace("torch.", "")   # numpy's spelling
        raise WitnessDtypeError(
            f"witness tensor {name!r} has dtype {dtype}, expected int64 "
            f"(exact-integer fixed-point carrier)")


def _require_shape(name: str, a: torch.Tensor, shape: tuple) -> None:
    if tuple(a.shape) != tuple(shape):
        raise WitnessShapeError(
            f"witness tensor {name!r} has shape {tuple(a.shape)}, key "
            f"geometry expects {tuple(shape)}")


def _require_range(name: str, a: torch.Tensor, lo: int, hi: int) -> None:
    """Require every element in [lo, hi): one ``aminmax`` on the
    tensor's device, two integers to the host."""
    if a.numel() == 0:
        return
    mn, mx = torch.stack(torch.aminmax(a)).tolist()
    if mn < lo or mx >= hi:
        raise WitnessRangeError(
            f"witness tensor {name!r} out of range [{lo}, {hi}): "
            f"min={mn} max={mx}")


def validate_witness(cfg, wit) -> None:
    """Validate one `StepWitness` against a compiled `PipelineConfig`
    (``pk.cfg`` / ``vk.cfg``).  Raises a `WitnessValidationError`
    subclass on the first violation; returns None when the witness is
    admissible.  Cost is O(witness size) elementwise on the witness's
    device — cheap next to a prove, safe to run on every submit."""
    from repro_torch.core.pipeline.graph import graph_skips

    # 1. quantization config
    if (wit.cfg.q_bits, wit.cfg.r_bits) != (cfg.q_bits, cfg.r_bits):
        raise WitnessQuantError(
            f"witness quantization (Q={wit.cfg.q_bits}, R={wit.cfg.r_bits})"
            f" != key quantization (Q={cfg.q_bits}, R={cfg.r_bits})")

    # 2. layer count + list lengths
    widths, B, L = cfg.widths, cfg.batch, cfg.n_layers
    if wit.n_layers != L:
        raise WitnessShapeError(
            f"witness has {wit.n_layers} layers, key geometry has {L}")
    lens = {"w": L, "z": L, "zpp": L, "b": L, "rz": L, "a": L, "gz": L,
            "ga": L - 1, "gap": L - 1, "rga": L - 1, "gw": L}
    for field, n in lens.items():
        got = len(getattr(wit, field))
        if got != n:
            raise WitnessShapeError(
                f"witness list {field!r} has {got} entries, expected {n}")

    # 3. per-tensor shapes + dtypes
    _require_shape("x", wit.x, (B, widths[0]))
    _require_shape("y", wit.y, (B, widths[L]))
    _require_int64("x", wit.x)
    _require_int64("y", wit.y)
    for l in range(L):
        _require_shape(f"w[{l}]", wit.w[l], (widths[l], widths[l + 1]))
        for field in ("z", "zpp", "b", "rz", "gz"):
            _require_shape(f"{field}[{l}]", getattr(wit, field)[l],
                           (B, widths[l + 1]))
        _require_shape(f"gw[{l}]", wit.gw[l], (widths[l + 1], widths[l]))
        _require_shape(f"a[{l}]", wit.a[l], (B, widths[l]))
        for field in ("w", "z", "zpp", "b", "rz", "a", "gz", "gw"):
            _require_int64(f"{field}[{l}]", getattr(wit, field)[l])
    for m in range(L - 1):
        for field in ("ga", "gap", "rga"):
            _require_shape(f"{field}[{m}]", getattr(wit, field)[m],
                           (B, widths[m + 1]))
            _require_int64(f"{field}[{m}]", getattr(wit, field)[m])

    # 4. residual topology
    expected_skips = graph_skips(cfg.graph)
    got_skips = {int(k): int(v) for k, v in wit.skips.items()}
    if got_skips != expected_skips:
        raise WitnessTopologyError(
            f"witness skip topology {got_skips} != graph topology "
            f"{expected_skips}")

    # 5. quantization ranges + rescale decompositions
    lim = 1 << (cfg.q_bits - 1)
    scale = 1 << cfg.r_bits
    _require_range("x", wit.x, -lim, lim)
    _require_range("y", wit.y, -lim, lim)
    for l in range(L):
        _require_range(f"w[{l}]", wit.w[l], -lim, lim)
        _require_range(f"zpp[{l}]", wit.zpp[l], 0, lim)
        _require_range(f"b[{l}]", wit.b[l], 0, 2)
        _require_range(f"rz[{l}]", wit.rz[l], 0, scale)
        # eq. (3): Z = 2^R (Z'' - 2^{Q-1} B) + R_Z
        zp = wit.zpp[l] - lim * wit.b[l]
        if not torch.equal(wit.z[l], scale * zp + wit.rz[l]):
            raise WitnessRangeError(
                f"layer {l}: zkReLU decomposition (eq. 3) does not hold "
                f"— z != 2^R*(zpp - 2^(Q-1)*b) + rz")
    for m in range(L - 1):
        _require_range(f"gap[{m}]", wit.gap[m], -lim, lim)
        _require_range(f"rga[{m}]", wit.rga[m], 0, scale)
        # eq. (5): G_A = 2^R G_A' + R_GA
        if not torch.equal(wit.ga[m], scale * wit.gap[m] + wit.rga[m]):
            raise WitnessRangeError(
                f"grad layer {m}: rescale decomposition (eq. 5) does not "
                f"hold — ga != 2^R*gap + rga")


def check_step_monotonic(tenant: str, expected: int,
                         declared: Optional[int]) -> int:
    """Gateway-side step-monotonicity check: a client that declares a
    step index must declare exactly the tenant's next one (steps are
    global and gap-free per tenant — the journal/window math depends on
    it).  Returns the step the submit will use."""
    if declared is not None and declared != expected:
        raise WitnessStepError(
            f"tenant {tenant!r}: declared step {declared} breaks the "
            f"monotonic sequence (next step is {expected}); steps are "
            f"assigned per tenant, gap-free and strictly increasing")
    return expected
