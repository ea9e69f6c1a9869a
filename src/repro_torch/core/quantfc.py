"""Quantized fully-connected network training step (Example 4.5 of zkDL).

All values are fixed-point integers at scale 2^R held in int64 tensors;
the witness this module produces is exactly the set of tensors Protocol
2 commits to and proves relations over:

    Z^l  = A^{l-1} W^l                       (30)  [scale 2^{2R}]
    A^l  = (1 - B^l) . Z''^l                 (31)  [scale 2^R]
    G_Z^L = Z^{L'} - Y                       (32)
    G_A^l = G_Z^{l+1} W^{l+1 T}              (33)  [scale 2^{2R}]
    G_W^l = G_Z^{l T} A^{l-1}                (34)  [scale 2^{2R}]
    G_Z^l = (1 - B^l) . G_A'^l               (35)

with the rescale/sign auxiliary decompositions of Section 4 (floor
rescaling, remainders in [0, 2^R)).  Data and weights are drawn with
numpy on the host (the reference's seeded streams) and moved to the
device.  Every exact integer product runs through the qmatmul kernel's
`qmatmul_i64` (four int8 digit products assembled in int64 on the
operands' device; its plain version on the CPU).  An operand outside
int16, such as the loss gradient Z' - Y or a residual sum A^{l-1} + A^j,
is split exactly into two int16 parts first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.qmatmul import qmatmul_i64

I16_MIN, I16_MAX = -(1 << 15), (1 << 15) - 1


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    q_bits: int = 16     # Q: rescaled values are Q-bit signed
    r_bits: int = 8      # R: scale factor 2^R

    @property
    def scale(self) -> int:
        return 1 << self.r_bits


def quantize(x: np.ndarray, cfg: QuantConfig) -> np.ndarray:
    """Real array -> fixed-point int64 at scale 2^R, clipped to Q-bit range
    (host numpy, the reference's exact arithmetic)."""
    v = np.floor(x * cfg.scale).astype(np.int64)
    lim = 1 << (cfg.q_bits - 1)
    return np.clip(v, -lim, lim - 1)


def dequantize(v: np.ndarray, cfg: QuantConfig) -> np.ndarray:
    """Fixed-point int64 at scale 2^R -> float64 (host numpy)."""
    return np.asarray(v).astype(np.float64) / cfg.scale


def _int16_parts(x: torch.Tensor) -> List[torch.Tensor]:
    """x -> int16 parts summing to x exactly: x itself when it fits,
    else clamp(x) and the rest.  Raises when the rest does not fit
    either (x outside [-2^16, 2^16 - 2])."""
    head = x.clamp(I16_MIN, I16_MAX)
    rest = x - head
    if not bool(rest.any()):
        return [head.to(torch.int16)]
    if bool(((rest < I16_MIN) | (rest > I16_MAX)).any()):
        raise OverflowError("exact_matmul: an operand needs more than two "
                            "int16 parts")
    return [head.to(torch.int16), rest.to(torch.int16)]


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 matrix product of int64 operands: every pair of their
    int16 parts through `qmatmul_i64`, the partial products added in
    int64."""
    out = None
    for pa in _int16_parts(a):
        for pb in _int16_parts(b):
            prod = qmatmul_i64(pa, pb)
            out = prod if out is None else out + prod
    return out


def rescale(v: torch.Tensor, cfg: QuantConfig):
    """v -> (floor(v / 2^R), remainder in [0, 2^R))."""
    vp = torch.div(v, cfg.scale, rounding_mode="floor")
    rem = v - vp * cfg.scale
    assert bool(((rem >= 0) & (rem < cfg.scale)).all())
    return vp, rem


def relu_aux(z: torch.Tensor, cfg: QuantConfig) -> Dict[str, torch.Tensor]:
    """Decompose Z per eq. (3): returns Z', Z'', B_{Q-1}, R_Z."""
    zp, r_z = rescale(z, cfg)
    lim = 1 << (cfg.q_bits - 1)
    if bool(((zp < -lim) | (zp >= lim)).any()):
        raise OverflowError("Z' exceeds Q-bit signed range; raise q_bits")
    b = (zp < 0).to(torch.int64)
    zpp = zp + lim * b
    assert bool(((zpp >= 0) & (zpp < lim)).all())
    return {"zp": zp, "zpp": zpp, "b": b, "rz": r_z}


def grad_aux(ga: torch.Tensor, cfg: QuantConfig) -> Dict[str, torch.Tensor]:
    """Decompose G_A per eq. (5): returns G_A', R_GA."""
    gap, r_ga = rescale(ga, cfg)
    lim = 1 << (cfg.q_bits - 1)
    if bool(((gap < -lim) | (gap >= lim)).any()):
        raise OverflowError("G_A' exceeds Q-bit signed range; raise q_bits")
    return {"gap": gap, "rga": r_ga}


@dataclasses.dataclass
class StepWitness:
    """Every tensor of one batch update, int64 tensors on one device.

    Shapes: x (B,d), y (B,d), w[l] (d,d), and per-layer (B,d) tensors.
    ``skips`` records the residual topology (matmul layer l -> earlier
    activation layer j, 1-indexed); gap/rga decompose the ACCUMULATED
    gradient arriving at each activation."""
    cfg: QuantConfig
    x: torch.Tensor
    y: torch.Tensor
    w: List[torch.Tensor]
    z: List[torch.Tensor]
    zpp: List[torch.Tensor]
    b: List[torch.Tensor]
    rz: List[torch.Tensor]
    a: List[torch.Tensor]        # a[0] = x, a[l] = relu output of layer l
    gz: List[torch.Tensor]       # gz[l], l = 1..L (1-indexed: gz[l-1])
    ga: List[torch.Tensor]       # ga[l] for l = 1..L-1 (accumulated totals)
    gap: List[torch.Tensor]
    rga: List[torch.Tensor]
    gw: List[torch.Tensor]
    skips: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def n_layers(self) -> int:
        return len(self.w)

    @property
    def device(self) -> torch.device:
        return self.x.device


def step_widths(wit: StepWitness):
    """The shape table d_0..d_L realized by one step witness."""
    return (wit.x.shape[1],) + tuple(w.shape[1] for w in wit.w)


def step_graph_witness(wit: StepWitness):
    """Graph-native view of a step witness: the layer graph implied by
    the witness shapes and residual topology, plus per-node named
    tensors via the op registry's witness extractors."""
    from repro_torch.core.pipeline.graph import (build_fcnn_graph,
                                                 build_residual_fcnn_graph,
                                                 extract_node_tensors)

    if wit.skips:
        graph = build_residual_fcnn_graph(step_widths(wit),
                                          wit.x.shape[0], wit.skips)
    else:
        graph = build_fcnn_graph(step_widths(wit), wit.x.shape[0])
    return graph, extract_node_tensors(graph, wit)


def _as_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                           else v, device=device).to(torch.int64)


def train_step_witness(x, y, ws, cfg: QuantConfig,
                       skips: Dict[int, int] | None = None,
                       device=None) -> StepWitness:
    """Forward + backward pass in exact integer arithmetic.

    ``x``, ``y``, ``ws`` are int64 numpy arrays or tensors; they move to
    ``device`` (default: the card, or the device of a tensor ``x``).
    ``skips`` (matmul layer l -> activation layer j, 1 <= j <= l - 2)
    adds residual connections as in the reference."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    device = resolve_device(device)
    x, y = _as_tensor(x, device), _as_tensor(y, device)
    ws = [_as_tensor(w, device) for w in ws]
    skips = dict(skips or {})
    n_layers = len(ws)
    skip0 = {}
    for l, j in skips.items():
        if not (1 <= j <= l - 2):
            raise ValueError(f"skip {l}->{j}: need 1 <= j <= l-2")
        if ws[l - 1].shape[0] != ws[j - 1].shape[1]:
            raise ValueError(f"skip {l}->{j}: width mismatch "
                             f"{ws[l - 1].shape[0]} != {ws[j - 1].shape[1]}")
        skip0[l - 1] = j
    a = [x]
    a_in = []
    z, zpp, bb, rz = [], [], [], []
    for l in range(n_layers):
        op = a[-1] + a[skip0[l]] if l in skip0 else a[-1]
        a_in.append(op)
        zl = exact_matmul(op, ws[l])
        aux = relu_aux(zl, cfg)
        z.append(zl)
        zpp.append(aux["zpp"])
        bb.append(aux["b"])
        rz.append(aux["rz"])
        if l < n_layers - 1:
            a.append((1 - aux["b"]) * aux["zpp"])
    # loss layer: square loss on rescaled output, eq (32)
    zp_last = zpp[-1] - (1 << (cfg.q_bits - 1)) * bb[-1]
    gz_last = zp_last - y

    gz = [None] * n_layers
    ga = [None] * (n_layers - 1)
    gap = [None] * (n_layers - 1)
    rga = [None] * (n_layers - 1)
    acc = [None] * n_layers    # accumulated gradient arriving at a[k]
    gz[n_layers - 1] = gz_last
    for m in range(n_layers - 1, 0, -1):
        g_in = exact_matmul(gz[m], ws[m].T)
        acc[m] = g_in if acc[m] is None else acc[m] + g_in
        if m in skip0:                   # backward split: both branches
            j = skip0[m]
            acc[j] = g_in if acc[j] is None else acc[j] + g_in
        aux = grad_aux(acc[m], cfg)
        ga[m - 1] = acc[m]
        gap[m - 1] = aux["gap"]
        rga[m - 1] = aux["rga"]
        gz[m - 1] = (1 - bb[m - 1]) * aux["gap"]
    gw = [exact_matmul(gz[l].T, a_in[l]) for l in range(n_layers)]
    return StepWitness(cfg=cfg, x=a[0], y=y, w=list(ws), z=z, zpp=zpp,
                       b=bb, rz=rz, a=a, gz=gz, ga=ga, gap=gap, rga=rga,
                       gw=gw, skips=skips)


def synthetic_sgd_trajectory(n_steps: int, n_layers: int, batch: int,
                             width: int, cfg: QuantConfig, seed: int = 0,
                             lr_shift: int = 8,
                             device=None) -> List[StepWitness]:
    """n_steps consecutive batch-update witnesses along an integer-SGD
    trajectory on seeded synthetic data (the reference's streams)."""
    return synthetic_sgd_trajectory_widths(
        n_steps, (width,) * (n_layers + 1), batch, cfg, seed=seed,
        lr_shift=lr_shift, device=device)


def synthetic_sgd_trajectory_widths(n_steps: int, widths, batch: int,
                                    cfg: QuantConfig, seed: int = 0,
                                    lr_shift: int = 8,
                                    skips: Dict[int, int] | None = None,
                                    device=None) -> List[StepWitness]:
    """Heterogeneous-shape twin of `synthetic_sgd_trajectory`: ``widths``
    is the full shape table d_0..d_L.  Draws exactly the reference's
    seeded numpy streams on the host."""
    device = resolve_device(device)
    widths = tuple(int(w) for w in widths)
    rng = np.random.default_rng(seed)
    ws = [quantize(rng.uniform(-1, 1, (widths[l], widths[l + 1])) * 0.3, cfg)
          for l in range(len(widths) - 1)]
    ws = [torch.as_tensor(w, device=device) for w in ws]
    wits = []
    for _ in range(n_steps):
        x = quantize(rng.uniform(-1, 1, (batch, widths[0])), cfg)
        y = quantize(rng.uniform(-1, 1, (batch, widths[-1])), cfg)
        wit = train_step_witness(x, y, ws, cfg, skips=skips, device=device)
        wits.append(wit)
        ws = sgd_apply(ws, wit.gw, lr_shift, cfg)
    return wits


def sgd_apply(ws: List[torch.Tensor], gw: List[torch.Tensor], lr_shift: int,
              cfg: QuantConfig) -> List[torch.Tensor]:
    """W <- W - G_W^T / 2^{lr_shift + R} (G_W is (out, in), W is (in, out))."""
    out = []
    lim = 1 << (cfg.q_bits - 1)
    for w, g in zip(ws, gw):
        step = torch.div(g, 1 << (lr_shift + cfg.r_bits),
                         rounding_mode="floor").T
        out.append(torch.clamp(w - step, -lim, lim - 1))
    return out
