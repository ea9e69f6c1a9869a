"""Pipeline configuration and commitment keys.

`PipelineConfig` carries the per-tensor shape table of the proof graph:
``widths`` is the full MLP shape vector d_0..d_L (input width, then one
out-width per layer), so heterogeneous pyramids like 784-512-256-128-10
are first-class.  The scalar ``width`` remains as the uniform shorthand
(``widths=None`` means every d_i = width).

Commitment keys are carved out of ONE unified generator vector
(`cfg.agg_blocks` / `make_keys`): every committed tensor slot owns a
disjoint slice of the direct-sum basis the single aggregated opening
IPA runs over (see openings.py), all sharing one blinding generator.

All committed tensors are stacked over graph slots AND training steps
(the layer-stacking trick of eq. 27, applied per FAC4DNN to the whole
(step, node) axis): each aux node gets a ``d_slot``-element slot, each
weight node a ``w_slot``-element slot, with per-node zero padding to the
common slot size.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import group, pedersen, zkrelu
from repro_torch.core.pipeline.graph import (LayerGraph, LayerOp,
                                             build_fcnn_graph, graph_widths)
from repro_torch.core.pipeline.tables import log2_exact, next_pow2


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_layers: int
    batch: int            # power of 2
    width: int = 0        # uniform layer width shorthand (widths wins)
    q_bits: int = 16
    r_bits: int = 8
    n_steps: int = 1      # T: training steps aggregated into one proof
    widths: Optional[Tuple[int, ...]] = None   # shape table d_0..d_L
    #: explicit graph nodes (residual MLPs etc.); None -> chain fcnn
    #: built from `widths`.  `compile()` is the usual way to set this.
    graph_spec: Optional[Tuple[LayerOp, ...]] = None

    def __post_init__(self):
        assert self.n_layers >= 2, "pipeline needs >= 2 layers (eq. 33)"
        assert self.n_steps >= 1
        assert self.batch == next_pow2(self.batch), "batch must be pow2"
        if self.widths is None:
            assert self.width >= 1, "pass width or widths"
            object.__setattr__(self, "widths",
                               (self.width,) * (self.n_layers + 1))
        else:
            object.__setattr__(self, "widths",
                               tuple(int(w) for w in self.widths))
            assert len(self.widths) == self.n_layers + 1, \
                "widths must be d_0..d_L (n_layers + 1 entries)"
            assert all(w >= 1 for w in self.widths)

    @classmethod
    def from_graph(cls, graph: LayerGraph, q_bits: int = 16,
                   r_bits: int = 8, n_steps: int = 1) -> "PipelineConfig":
        """Derive the full config from a `LayerGraph`: the graph is the
        single source of truth for shapes; only the quantization and the
        aggregation window are free parameters."""
        widths = graph_widths(graph)
        return cls(n_layers=len(widths) - 1, batch=graph.batch,
                   q_bits=q_bits, r_bits=r_bits, n_steps=n_steps,
                   widths=widths, graph_spec=graph.nodes)

    @property
    def is_uniform(self) -> bool:
        return len(set(self.widths)) == 1

    @functools.cached_property
    def graph(self) -> LayerGraph:
        """The layer-graph IR every pipeline stage iterates over."""
        if self.graph_spec is not None:
            return LayerGraph(self.graph_spec)
        return build_fcnn_graph(self.widths, self.batch)

    # -- stacked-axis geometry (all powers of two) ------------------------
    @property
    def l_pad(self) -> int:
        """Aux-slot axis length (one slot per zkReLU node)."""
        return next_pow2(len(self.graph.aux_nodes))

    @property
    def lw_pad(self) -> int:
        """Weight-slot axis length (one slot per qmatmul node)."""
        return next_pow2(len(self.graph.weight_nodes))

    @property
    def t_pad(self) -> int:
        return next_pow2(self.n_steps)

    @property
    def s_pad(self) -> int:
        """Slots on the stacked (step, aux node) axis; node varies fastest."""
        return self.t_pad * self.l_pad

    @property
    def sw_pad(self) -> int:
        return self.t_pad * self.lw_pad

    @property
    def d_elem(self) -> int:
        """Element area of one aux slot (batch x max padded width)."""
        return self.graph.d_slot

    @property
    def w_elem(self) -> int:
        return self.graph.w_slot

    @property
    def d_stack(self) -> int:
        """Stacked aux length: elem vars low, then node vars, then step."""
        return self.s_pad * self.d_elem

    @property
    def w_stack(self) -> int:
        return self.sw_pad * self.w_elem

    @property
    def y_elem(self) -> int:
        return self.graph.y_elem

    @property
    def y_stack(self) -> int:
        return self.t_pad * self.y_elem

    @property
    def x_len(self) -> int:
        """Per-sample data vector length (padded input width)."""
        return self.graph.input_node.cols_pad

    def slot(self, t: int, node_idx: int) -> int:
        """Flat (step, aux node) slot index; node_idx is 0-based."""
        assert 0 <= t < self.t_pad and 0 <= node_idx < self.l_pad
        return t * self.l_pad + node_idx

    def wslot(self, t: int, node_idx: int) -> int:
        """Flat (step, weight node) slot index."""
        assert 0 <= t < self.t_pad and 0 <= node_idx < self.lw_pad
        return t * self.lw_pad + node_idx

    # -- unified direct-sum opening layout (see openings.py) --------------
    def slot_stack_len(self, spec) -> int:
        """Stacked commitment length of one schema `TensorSlot`."""
        return {"aux": self.d_stack, "weight": self.w_stack,
                "label": self.y_stack}[spec.axis]

    @functools.cached_property
    def agg_blocks(self) -> Tuple[Tuple[str, int, int], ...]:
        """The direct-sum block table of the ONE aggregated opening IPA:
        ``(name, offset, length)`` per block, schema slots first (in
        `commit_slots` order — the transcript absorption order), then the
        two homomorphic data-fold blocks "x1"/"x2".  Block k's evaluation
        vector is weighted by rho^k, so this order is part of the
        protocol."""
        out, off = [], 0
        for spec in self.graph.commit_slots:
            n = self.slot_stack_len(spec)
            out.append((spec.name, off, n))
            off += n
        for tag in ("x1", "x2"):
            out.append((tag, off, self.x_len))
            off += self.x_len
        return tuple(out)

    @property
    def agg_len(self) -> int:
        """Unified opening vector length: the block sum padded to a
        power of two (pad generators are fresh; pad witness is zero)."""
        last = self.agg_blocks[-1]
        return next_pow2(last[1] + last[2])

    @functools.cached_property
    def validity_blocks(self) -> Tuple[Tuple[str, int, int], ...]:
        """The zkReLU validity statements' slices of the MERGED opening
        vector: ``(name, offset, length)`` with offsets continuing past
        the (padded) open region, so the one aggregated IPA covers
        open blocks ++ main validity ++ remainder validity ++ pad."""
        n_main = 2 * self.d_stack * self.q_bits
        n_rem = 2 * self.d_stack * self.r_bits
        return (("vmain", self.agg_len, n_main),
                ("vrem", self.agg_len + n_main, n_rem))

    @property
    def merged_len(self) -> int:
        """Length of the merged (open + validity) opening vector."""
        last = self.validity_blocks[-1]
        return next_pow2(last[1] + last[2])

    # -- challenge-point sizes (see challenges.py) ------------------------
    @property
    def lb(self) -> int:
        return log2_exact(self.batch)

    @property
    def la(self) -> int:
        """log2 of one aux slot's element area."""
        return log2_exact(self.d_elem)

    @property
    def lw(self) -> int:
        return log2_exact(self.w_elem)

    @property
    def lj(self) -> int:
        """Low-var split of the weight elem point: log2(max padded
        in-width).  Uniform graphs give lj = log2(width) so the drawn
        u_i / u_j vectors match the seed transcript exactly."""
        return log2_exact(max(self.graph.weight_shape(n)[0]
                              for n in self.graph.weight_nodes))


@dataclasses.dataclass(frozen=True)
class PipelineKeys:
    """Commitment key material laid out for the ONE aggregated opening.

    ``k_agg`` is the unified direct-sum basis of `cfg.agg_blocks`: every
    commitment slot's generators are a DISJOINT slice of it (disjointness
    is what makes the cross-slot batching sound — shared generators would
    let a prover shift witness mass between blocks), all under one shared
    blinding generator so the per-slot blinds sum into the aggregated
    Schnorr opening.  One exception to freshness: the "x2" block reuses
    the "x1" slice, because both data folds derive homomorphically from
    the same per-sample commitments — those fold claims are additionally
    pinned by the bucket sumcheck finals they must equal.  (The ``bq``
    block is fresh too: the validity argument's own B_{Q-1} column
    commitment is published separately by `zkrelu.commit_validity`, so
    no zkReLU generator repeats inside the merged basis.)

    ``g_merged`` / ``h_merged`` extend the opening basis with the zkReLU
    validity slices (`cfg.validity_blocks`): G side is k_agg.gens ++
    validity G ++ G_R ++ fresh pad, H side is the fresh ``h_open`` ++
    validity H ++ H_R ++ fresh pad.  The single pair IPA of
    `openings.prove` runs over these; the open region's b-vector is
    public, so its H-slice commitment factor is added by the verifier.
    """
    cfg: PipelineConfig
    k_agg: pedersen.CommitKey     # unified basis (agg_len), one blind gen
    slot_keys: Dict[str, pedersen.CommitKey]   # schema slot -> basis slice
    kx: pedersen.CommitKey        # per-sample data vectors (x1/x2 slice)
    validity: zkrelu.ValidityKeys
    h_open: torch.Tensor           # (agg_len,) H basis of the open region
    g_merged: torch.Tensor         # (merged_len,)
    h_merged: torch.Tensor         # (merged_len,)

    # first-round accel squaring chains for the merged bases (see
    # zkrelu.POW_TABLE_MAX_ELEMS for the size guard at the call site)
    @functools.cached_property
    def g_merged_table(self) -> torch.Tensor:
        return group.pow_table(self.g_merged)

    @functools.cached_property
    def h_merged_table(self) -> torch.Tensor:
        return group.pow_table(self.h_merged)

    @property
    def k_bq(self) -> pedersen.CommitKey:
        """B_{Q-1} bit commitments (zkReLU G-column basis slice)."""
        return self.slot_keys["bq"]

    @property
    def device(self) -> torch.device:
        return self.g_merged.device

    def slot_key(self, spec) -> pedersen.CommitKey:
        """The commitment key of one schema `TensorSlot` (bit-matrix
        slots use k_bq via `pedersen.commit_bits` instead)."""
        return self.slot_keys[spec.name]


def make_keys(cfg: PipelineConfig, device) -> PipelineKeys:
    """Derive every generator of the config on ``device`` (the generator
    kernel on the card)."""
    vk = zkrelu.make_validity_keys(cfg.d_stack, cfg.q_bits, cfg.r_bits,
                                   device)
    h = vk.h_blind
    # one deterministic derivation covers every fresh block plus the
    # power-of-two pad tail; only x2 (the x1 slice) is spliced in
    blocks = cfg.agg_blocks
    fresh_len = sum(n for name, _, n in blocks if name != "x2")
    total = blocks[-1][1] + blocks[-1][2]
    fresh = group.derive_generators(b"zkdl/gens/agg",
                                    fresh_len + (cfg.agg_len - total), device)
    parts, taken, slot_gens = [], 0, {}
    for name, _, n in blocks:
        if name == "x2":
            gens = slot_gens["x1"]
        else:
            gens = fresh[taken: taken + n]
            taken += n
        slot_gens[name] = gens
        parts.append(gens)
    parts.append(fresh[taken:])                       # pad tail
    k_agg = pedersen.CommitKey(torch.cat(parts), h, b"zkdl/agg")
    slot_keys = {s.name: pedersen.CommitKey(slot_gens[s.name], h,
                                            b"zkdl/slot/" + s.name.encode())
                 for s in cfg.graph.commit_slots}
    # merged (open + validity) bases: the open region gets a fresh H
    # side (its b-vector is public -- the verifier multiplies the H
    # factor in itself), the validity slices reuse the vk bases so
    # Algorithm 1's transformed commitments line up, and the tail pad
    # is fresh on both sides
    vtotal = cfg.validity_blocks[-1][1] + cfg.validity_blocks[-1][2]
    vpad = cfg.merged_len - vtotal
    h_open = group.derive_generators(b"zkdl/gens/aggH", cfg.agg_len, device)
    gparts = [k_agg.gens, vk.g_big, vk.g_r]
    hparts = [h_open, vk.h_big, vk.h_r]
    if vpad:
        gparts.append(group.derive_generators(b"zkdl/gens/vpadG", vpad,
                                              device))
        hparts.append(group.derive_generators(b"zkdl/gens/vpadH", vpad,
                                              device))
    g_merged = torch.cat(gparts)
    h_merged = torch.cat(hparts)
    return PipelineKeys(
        cfg=cfg, k_agg=k_agg, slot_keys=slot_keys,
        kx=pedersen.CommitKey(slot_gens["x1"], h, b"zkdl/x"),
        validity=vk, h_open=h_open, g_merged=g_merged, h_merged=h_merged)
