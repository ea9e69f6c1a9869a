"""FAC4DNN layer-graph IR: heterogeneous-layer proof aggregation.

The paper's point (Section 5) is that proofs aggregate over *different
layers and training steps without being constrained by their sequential
order*.  The seed pipeline realized that only for the uniform-width
quantized FCNN of Example 4.5; this module makes the network shape a
first-class object instead:

* `LayerOp` — one node of the proof graph (input, quantized matmul,
  zkReLU rescale/activation, residual add, output gradient) with an
  explicit unpadded shape and explicit edges to its producers.
* `OP_REGISTRY` — per-kind `OpSpec` supplying shape validation, the
  witness extractor (node -> named int64 tensors of one `StepWitness`),
  and the sumcheck relation handler (node -> `MatmulInstance`s).  The
  zkReLU / output-gradient relation checks live in `anchor.py` /
  `openings.py` but are *driven* by the slot and claim enumerations
  defined here.
* `LayerGraph` — the validated graph plus everything the prover and the
  standalone verifier both derive from it: aux/weight slot maps, padded
  slot sizes, matmul relation instances, and the **shape buckets**.

Shape buckets are the aggregation mechanism: every matmul relation
instance (one per (family, layer), replicated per aggregated training
step) is keyed by its sumcheck table length (the padded inner dimension)
and all instances in a bucket — across layers AND steps — share ONE
batched sumcheck, entering with public coefficient
``e(u_slot)[slot(t, node)] * padfac`` exactly like the seed's three
hardcoded fwd/bwd/gw sumchecks.  A uniform-width graph degenerates to
one bucket per family, reproducing the seed transcript bit-for-bit.

Slot layout (little-endian MLE variables, low to high):

    aux slot:    [cols of node tensor | rows (batch) | zero pad]  d_slot
    weight slot: [cols (in-width)     | rows (out)   | zero pad]  w_slot

so a claim on a node tensor at point ``p`` becomes a claim on the
stacked commitment at ``p ++ zeros ++ slot-selector``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.pipeline.tables import log2_exact, next_pow2

FAMILIES = ("fwd", "bwd", "gw")


@dataclasses.dataclass(frozen=True)
class LayerOp:
    """One node of the proof graph.

    ``shape`` is the UNPADDED (rows, cols) of the node's output tensor;
    padded sizes are derived (each dim to the next power of two).
    ``layer`` is the 1-based layer index used for witness extraction and
    transcript tags (0 for the input node).
    """
    name: str
    kind: str                      # key into OP_REGISTRY
    inputs: Tuple[str, ...]
    shape: Tuple[int, int]
    layer: int = 0

    @property
    def rows_pad(self) -> int:
        return next_pow2(self.shape[0])

    @property
    def cols_pad(self) -> int:
        return next_pow2(self.shape[1])

    @property
    def elem_pad(self) -> int:
        return self.rows_pad * self.cols_pad


@dataclasses.dataclass(frozen=True)
class MatmulInstance:
    """One matmul relation of one layer (replicated per training step).

    The claim tensor is the product result: Z^l for fwd (eq. 30),
    G_A^l for bwd (eq. 33), G_W^l for gw (eq. 34).  ``claim_slots`` are
    the stacked-axis slots the claim reduces to (aux slots for fwd/bwd,
    weight slot for gw) — more than one exactly when the claim tensor is
    the gradient of a residual sum, whose committed decomposition splits
    linearly over every producer slot; ``inner`` is the padded inner
    dimension — the sumcheck table length and therefore the bucket key.
    """
    family: str
    layer: int
    claim_rows: int        # padded rows of the claim tensor
    claim_cols: int        # padded cols of the claim tensor
    inner: int             # padded contraction length (bucket key)
    claim_slots: Tuple[int, ...]   # aux (fwd/bwd) or weight (gw) slot indices
    a_node: str            # activation operand node name ("" for bwd)


@dataclasses.dataclass(frozen=True)
class TensorSlot:
    """One named committed-tensor family an op kind contributes to.

    ``axis`` names the stacked commitment the tensors land in: "aux"
    (per-(step, aux-node) slots under key kd), "weight" (per-(step,
    weight-node) slots under kw) or "label" (per-step, under ky).
    ``bits`` marks the B_{Q-1} bit matrix, committed under the zkReLU
    G-column basis via `pedersen.commit_bits` instead of an MSM.
    ``pad_shape(op, graph)`` gives the padded (rows, cols) of one node's
    tensor inside its slot; None means the node's own padded shape.

    The ordered union of these specs over a graph's nodes
    (`LayerGraph.commit_slots`) IS the commitment schema: witness
    stacking, the commit phase, blind drawing, transcript absorption and
    proof serialization all iterate it, so a new op kind only declares
    its slots here and every downstream layer picks them up.
    """
    name: str
    axis: str                  # "aux" | "weight" | "label"
    bits: bool = False
    pad_shape: Optional[Callable[["LayerOp", "LayerGraph"],
                                 Tuple[int, int]]] = None


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Registry entry: everything the pipeline needs to know per op kind."""
    kind: str
    owns_aux_slot: bool        # node gets a slot in the stacked aux tensors
    owns_weight_slot: bool     # node gets a slot in the stacked W / G_W
    validate: Callable[["LayerOp", "LayerGraph"], None]
    extract: Callable[["LayerOp", object], Dict[str, torch.Tensor]]
    relations: Callable[["LayerOp", "LayerGraph"], List[MatmulInstance]]
    slots: Tuple[TensorSlot, ...] = ()


OP_REGISTRY: Dict[str, OpSpec] = {}


def register_op(spec: OpSpec) -> OpSpec:
    if spec.kind in OP_REGISTRY:
        raise ValueError(f"op kind {spec.kind!r} already registered")
    OP_REGISTRY[spec.kind] = spec
    return spec


def _no_relations(op, graph):
    return []


def _no_tensors(op, wit):
    return {}


# ---------------------------------------------------------------------------
# Op kinds
# ---------------------------------------------------------------------------

def _validate_input(op: LayerOp, graph: "LayerGraph") -> None:
    if op.inputs:
        raise ValueError(f"{op.name}: input node takes no inputs")


def _validate_qmatmul(op: LayerOp, graph: "LayerGraph") -> None:
    (src,) = op.inputs
    a = graph.node(src)
    if a.shape[0] != op.shape[0]:
        raise ValueError(f"{op.name}: batch {op.shape[0]} != producer "
                         f"{src} batch {a.shape[0]}")
    # implied weight shape: (in=a.cols, out=op.cols); both must be >= 1
    if a.shape[1] < 1 or op.shape[1] < 1:
        raise ValueError(f"{op.name}: degenerate weight shape")


def _validate_same_shape(op: LayerOp, graph: "LayerGraph") -> None:
    for src in op.inputs:
        if graph.node(src).shape != op.shape:
            raise ValueError(f"{op.name}: shape {op.shape} != producer "
                             f"{src} shape {graph.node(src).shape}")


def _extract_qmatmul(op: LayerOp, wit) -> Dict[str, torch.Tensor]:
    l = op.layer
    return {"w": wit.w[l - 1], "gw": wit.gw[l - 1]}


def _extract_zkrelu(op: LayerOp, wit) -> Dict[str, torch.Tensor]:
    l, L = op.layer, len(wit.w)
    zero = torch.zeros_like(wit.zpp[l - 1])
    return {
        "zpp": wit.zpp[l - 1], "bq": wit.b[l - 1], "rz": wit.rz[l - 1],
        # the output layer has no downstream G_A (its gradient comes from
        # the loss, eq. 32), so its grad-aux slots stay exactly zero
        "gap": wit.gap[l - 1] if l < L else zero,
        "rga": wit.rga[l - 1] if l < L else zero,
    }


def _extract_output_grad(op: LayerOp, wit) -> Dict[str, torch.Tensor]:
    return {"y": wit.y}


def _extract_residual(op: LayerOp, wit) -> Dict[str, torch.Tensor]:
    # A residual sum commits nothing of its own: its value is implied by
    # its producers' committed decompositions, and every claim on it
    # splits linearly onto their slots (see producer_aux_slots).
    return {}


def _validate_residual(op: LayerOp, graph: "LayerGraph") -> None:
    if len(op.inputs) != 2:
        raise ValueError(f"{op.name}: residual_add takes exactly 2 inputs")
    _validate_same_shape(op, graph)
    for src in op.inputs:
        kind = graph.node(src).kind
        if kind not in ("zkrelu", "residual_add"):
            raise ValueError(
                f"{op.name}: residual producer {src!r} is a {kind!r} node; "
                "claims on a residual sum must discharge onto committed "
                "activation slots, so both producers must be zkrelu (or "
                "nested residual_add) nodes")


def _relations_qmatmul(op: LayerOp, graph: "LayerGraph") -> List[MatmulInstance]:
    """The three Fig. 3 relation instances a quantized matmul owns.

    fwd (eq. 30): Z^l = A^{l-1} W^l, claim on layer l's aux slot.
    gw  (eq. 34): G_W^l = G_Z^{l,T} A^{l-1}, claim on weight slot l.
    bwd (eq. 33): G_A^{l-1} = G_Z^l W^{l,T} — attached to layer l because
    it contracts over layer l's OUT width and reads W^l; the claim lands
    on the producer slot(s) of layer l's OPERAND: the upstream zkrelu
    node for a chain, BOTH producer slots when the operand is a residual
    sum (the gradient of A1 + A2 flows to both branches, and each
    branch's committed gap/rga decomposes its accumulated total, so the
    instance enters its bucket with the SUM of both slot coefficients).
    Layer 1 has no upstream activation, so it emits no bwd instance (and
    its A-operand is the input node, whose claims discharge through the
    per-sample data commitments instead of the anchor).
    """
    (src,) = op.inputs
    a = graph.node(src)
    act = graph.node_for_layer("zkrelu", op.layer)
    out: List[MatmulInstance] = []
    out.append(MatmulInstance(
        family="fwd", layer=op.layer, claim_rows=op.rows_pad,
        claim_cols=op.cols_pad, inner=a.cols_pad,
        claim_slots=(graph.aux_slot(act.name),), a_node=src))
    if op.layer > 1:
        out.append(MatmulInstance(
            family="bwd", layer=op.layer - 1, claim_rows=a.rows_pad,
            claim_cols=a.cols_pad, inner=op.cols_pad,
            claim_slots=graph.producer_aux_slots(src), a_node=""))
    out.append(MatmulInstance(
        family="gw", layer=op.layer, claim_rows=op.cols_pad,
        claim_cols=a.cols_pad, inner=op.rows_pad,
        claim_slots=(graph.weight_slot(op.name),), a_node=src))
    return out


def _w_shape(op: LayerOp, graph: "LayerGraph") -> Tuple[int, int]:
    return graph.weight_shape(op)


def _gw_shape(op: LayerOp, graph: "LayerGraph") -> Tuple[int, int]:
    rp, cp = graph.weight_shape(op)
    return cp, rp           # G_W^l = G_Z^{l,T} A^{l-1} is (out, in)


register_op(OpSpec("input", False, False, _validate_input,
                   _no_tensors, _no_relations))
register_op(OpSpec("qmatmul", False, True, _validate_qmatmul,
                   _extract_qmatmul, _relations_qmatmul,
                   slots=(TensorSlot("w", "weight", pad_shape=_w_shape),
                          TensorSlot("gw", "weight", pad_shape=_gw_shape))))
register_op(OpSpec("zkrelu", True, False, _validate_same_shape,
                   _extract_zkrelu, _no_relations,
                   slots=(TensorSlot("zpp", "aux"),
                          TensorSlot("bq", "aux", bits=True),
                          TensorSlot("rz", "aux"),
                          TensorSlot("gap", "aux"),
                          TensorSlot("rga", "aux"))))
register_op(OpSpec("residual_add", False, False, _validate_residual,
                   _extract_residual, _no_relations))
register_op(OpSpec("output_grad", False, False, _validate_same_shape,
                   _extract_output_grad, _no_relations,
                   slots=(TensorSlot("y", "label"),)))


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bucket:
    """All relation instances of one family sharing a sumcheck table
    length; ONE batched sumcheck proves every (instance, step) pair."""
    family: str
    inner: int
    instances: Tuple[MatmulInstance, ...]

    @property
    def rounds(self) -> int:
        return log2_exact(self.inner)


@dataclasses.dataclass(frozen=True)
class LayerGraph:
    nodes: Tuple[LayerOp, ...]

    def __post_init__(self):
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError("duplicate node names")
        for op in self.nodes:
            if op.kind not in OP_REGISTRY:
                raise ValueError(f"{op.name}: unregistered op kind "
                                 f"{op.kind!r}; known: {sorted(OP_REGISTRY)}")
            for src in op.inputs:
                if src not in names[:names.index(op.name)]:
                    raise ValueError(f"{op.name}: input {src!r} is not an "
                                     "earlier node (graph must be in "
                                     "topological order)")
            OP_REGISTRY[op.kind].validate(op, self)

    # -- lookups ----------------------------------------------------------
    def node(self, name: str) -> LayerOp:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def node_for_layer(self, kind: str, layer: int) -> LayerOp:
        for n in self.nodes:
            if n.kind == kind and n.layer == layer:
                return n
        raise KeyError((kind, layer))

    # -- slot maps --------------------------------------------------------
    @functools.cached_property
    def aux_nodes(self) -> Tuple[LayerOp, ...]:
        """Nodes owning a stacked-aux slot, in slot order."""
        return tuple(n for n in self.nodes
                     if OP_REGISTRY[n.kind].owns_aux_slot)

    @functools.cached_property
    def weight_nodes(self) -> Tuple[LayerOp, ...]:
        return tuple(n for n in self.nodes
                     if OP_REGISTRY[n.kind].owns_weight_slot)

    def aux_slot(self, name: str) -> int:
        return [n.name for n in self.aux_nodes].index(name)

    def weight_slot(self, name: str) -> int:
        return [n.name for n in self.weight_nodes].index(name)

    def producer_aux_slots(self, name: str) -> Tuple[int, ...]:
        """The aux slots a claim on node `name`'s value decomposes onto.

        A zkrelu node is its own slot; a residual_add resolves through
        both producers (a claim on A1 + A2 at point p IS the sum of the
        claims on A1 and A2 at p, so it splits linearly onto every
        producer slot — the FAC4DNN claim routing for skip connections).
        """
        node = self.node(name)
        if OP_REGISTRY[node.kind].owns_aux_slot:
            return (self.aux_slot(name),)
        if node.kind == "residual_add":
            out: List[int] = []
            for src in node.inputs:
                out.extend(self.producer_aux_slots(src))
            return tuple(out)
        raise ValueError(f"{name}: {node.kind!r} node owns no aux slot and "
                         "is not a residual sum of slot owners")

    # -- commitment schema ------------------------------------------------
    @functools.cached_property
    def commit_slots(self) -> Tuple[TensorSlot, ...]:
        """The ordered named-tensor commitment schema of this graph: the
        union of every node's `OpSpec.slots`, label axis first, then
        weight, then aux (the canonical transcript absorption order),
        declaration order within an axis.  Witness stacking, the commit
        phase, blind drawing and proof serialization all iterate this —
        a new op kind's tensors flow through by declaring slots alone."""
        axis_rank = {"label": 0, "weight": 1, "aux": 2}
        seen, out = set(), []
        for op in self.nodes:
            for s in OP_REGISTRY[op.kind].slots:
                if s.name not in seen:
                    seen.add(s.name)
                    out.append(s)
        return tuple(sorted(out, key=lambda s: axis_rank[s.axis]))

    def slot_nodes(self, spec: TensorSlot) -> Tuple[LayerOp, ...]:
        """The nodes contributing tensors to one named commitment slot,
        in stacked-slot order."""
        if spec.axis == "aux":
            return self.aux_nodes
        if spec.axis == "weight":
            return self.weight_nodes
        return (self.output_node,)

    def slot_pad_shape(self, spec: TensorSlot, op: LayerOp) -> Tuple[int, int]:
        if spec.pad_shape is not None:
            return spec.pad_shape(op, self)
        return op.rows_pad, op.cols_pad

    # -- node activation values (prover-side operand resolution) ----------
    def node_value(self, name: str, wit) -> torch.Tensor:
        """The int64 forward value of an activation-producing node in one
        `StepWitness`: input -> x, zkrelu layer l -> A^l, residual_add ->
        the elementwise sum of its producers (computed, never committed)."""
        node = self.node(name)
        if node.kind == "input":
            return wit.x
        if node.kind == "zkrelu":
            return wit.a[node.layer]
        if node.kind == "residual_add":
            vals = [self.node_value(src, wit) for src in node.inputs]
            return vals[0] + vals[1]
        raise ValueError(f"{name}: {node.kind!r} has no activation value")

    # -- padded geometry --------------------------------------------------
    @property
    def batch(self) -> int:
        return self.nodes[0].shape[0]

    @functools.cached_property
    def d_slot(self) -> int:
        """Element area of one aux slot (shared by all aux nodes)."""
        return max(n.rows_pad * n.cols_pad for n in self.aux_nodes)

    @functools.cached_property
    def w_slot(self) -> int:
        """Element area of one weight slot: max padded in*out."""
        return max(self.weight_shape(n)[0] * self.weight_shape(n)[1]
                   for n in self.weight_nodes)

    def weight_shape(self, op: LayerOp) -> Tuple[int, int]:
        """Padded (rows=in, cols=out) of a qmatmul node's weight."""
        (src,) = op.inputs
        return self.node(src).cols_pad, op.cols_pad

    @functools.cached_property
    def output_node(self) -> LayerOp:
        outs = [n for n in self.nodes if n.kind == "output_grad"]
        if len(outs) != 1:
            raise ValueError(f"graph needs exactly one output_grad node, "
                             f"got {len(outs)}")
        return outs[0]

    @property
    def y_elem(self) -> int:
        """Per-step padded label area: batch x padded output width."""
        o = self.output_node
        return o.rows_pad * o.cols_pad

    @functools.cached_property
    def input_node(self) -> LayerOp:
        ins = [n for n in self.nodes if n.kind == "input"]
        if len(ins) != 1:
            raise ValueError("graph needs exactly one input node")
        return ins[0]

    # -- relation instances and shape buckets -----------------------------
    @functools.cached_property
    def instances(self) -> Dict[str, Tuple[MatmulInstance, ...]]:
        """Per family, all relation instances in layer order."""
        per: Dict[str, List[MatmulInstance]] = {f: [] for f in FAMILIES}
        for op in self.nodes:
            for inst in OP_REGISTRY[op.kind].relations(op, self):
                per[inst.family].append(inst)
        for fam in per:
            per[fam].sort(key=lambda i: i.layer)
        return {f: tuple(v) for f, v in per.items()}

    @functools.cached_property
    def buckets(self) -> Dict[str, Tuple[Bucket, ...]]:
        """Instances grouped by sumcheck table length (first-seen order,
        so a uniform graph yields exactly one bucket per family)."""
        out: Dict[str, Tuple[Bucket, ...]] = {}
        for fam, insts in self.instances.items():
            grouped: Dict[int, List[MatmulInstance]] = {}
            for inst in insts:
                grouped.setdefault(inst.inner, []).append(inst)
            out[fam] = tuple(Bucket(fam, inner, tuple(g))
                             for inner, g in grouped.items())
        return out

    @functools.cached_property
    def locators(self) -> Dict[str, Dict[int, Tuple[int, int]]]:
        """Per family: layer -> (bucket index, position inside bucket).

        The pair index of (step t, layer) inside its bucket's sumcheck is
        ``t * len(bucket.instances) + position``."""
        out: Dict[str, Dict[int, Tuple[int, int]]] = {}
        for fam, buckets in self.buckets.items():
            m: Dict[int, Tuple[int, int]] = {}
            for bi, b in enumerate(buckets):
                for pos, inst in enumerate(b.instances):
                    m[inst.layer] = (bi, pos)
            out[fam] = m
        return out

    def locate(self, family: str, layer: int) -> Tuple[int, int]:
        return self.locators[family][layer]

    def instance(self, family: str, layer: int) -> MatmulInstance:
        bi, pos = self.locate(family, layer)
        return self.buckets[family][bi].instances[pos]


def extract_node_tensors(graph: LayerGraph, wit) -> Dict[str, Dict]:
    """One step's tensors keyed by graph node name, via the op
    registry's witness extractors -- the single graph-native view of a
    `StepWitness` (used by both witness stacking and
    `quantfc.step_graph_witness`)."""
    return {op.name: OP_REGISTRY[op.kind].extract(op, wit)
            for op in graph.nodes}


# ---------------------------------------------------------------------------
# Builders + the family registry (launch-time lookup)
# ---------------------------------------------------------------------------

def build_fcnn_graph(widths: Tuple[int, ...], batch: int) -> LayerGraph:
    """The (possibly pyramid) MLP graph of Example 4.5: widths is the
    full shape table d_0..d_L (input width, then one out-width per
    layer).  Uniform widths reproduce the seed pipeline exactly."""
    widths = tuple(int(w) for w in widths)
    if len(widths) < 3:
        raise ValueError("fcnn graph needs >= 2 layers (eq. 33): pass "
                         "widths d_0..d_L with L >= 2")
    L = len(widths) - 1
    nodes: List[LayerOp] = [LayerOp("x", "input", (), (batch, widths[0]))]
    prev = "x"
    for l in range(1, L + 1):
        nodes.append(LayerOp(f"mm{l}", "qmatmul", (prev,),
                             (batch, widths[l]), layer=l))
        nodes.append(LayerOp(f"act{l}", "zkrelu", (f"mm{l}",),
                             (batch, widths[l]), layer=l))
        prev = f"act{l}"
    nodes.append(LayerOp("loss", "output_grad", (prev,),
                         (batch, widths[L]), layer=L))
    return LayerGraph(tuple(nodes))


def build_residual_fcnn_graph(widths: Tuple[int, ...], batch: int,
                              skips: Dict[int, int]) -> LayerGraph:
    """A residual MLP: ``skips`` maps matmul layer l -> earlier
    activation layer j (1 <= j <= l - 2), meaning layer l's operand is
    A^{l-1} + A^j (both zkrelu outputs, so shapes must match:
    widths[l-1] == widths[j]).  Equivalent to `GraphBuilder` with a
    ``residual(to=...)`` before each skipped dense."""
    widths = tuple(int(w) for w in widths)
    L = len(widths) - 1
    b = GraphBuilder(batch).input(widths[0])
    for l in range(1, L + 1):
        if l in skips:
            b.residual(to=skips[l])
        b.dense(widths[l]).relu()
    return b.output()


class GraphBuilder:
    """Fluent frontend for proof graphs:

        graph = (GraphBuilder(batch=4)
                 .input(16).dense(16).relu()
                 .dense(16).relu()
                 .residual(to=1)          # tip := act2 + act1
                 .dense(8).relu()
                 .output())

    ``dense(h)`` appends a quantized matmul to width h consuming the
    current tip, ``relu()`` its zkReLU rescale/activation, and
    ``residual(to=...)`` replaces the tip with tip + (an earlier
    activation, by layer index or node name) so the NEXT dense consumes
    the sum.  ``output()`` closes the graph and returns the validated
    `LayerGraph`."""

    def __init__(self, batch: int):
        self.batch = int(batch)
        self._nodes: List[LayerOp] = []
        self._tip: Optional[str] = None
        self._layer = 0
        self._n_res = 0

    def _shape(self, name: str) -> Tuple[int, int]:
        for n in self._nodes:
            if n.name == name:
                return n.shape
        raise KeyError(name)

    def _expect(self, what: str, ok: bool) -> None:
        if not ok:
            raise ValueError(f"GraphBuilder: {what}")

    def input(self, d: int) -> "GraphBuilder":
        self._expect("input() must come first", not self._nodes)
        self._nodes.append(LayerOp("x", "input", (), (self.batch, int(d))))
        self._tip = "x"
        return self

    def dense(self, h: int) -> "GraphBuilder":
        self._expect("dense() needs an input/relu/residual tip",
                     self._tip is not None and not self._tip.startswith("mm"))
        self._layer += 1
        l = self._layer
        self._nodes.append(LayerOp(f"mm{l}", "qmatmul", (self._tip,),
                                   (self.batch, int(h)), layer=l))
        self._tip = f"mm{l}"
        return self

    def relu(self) -> "GraphBuilder":
        self._expect("relu() must follow dense()",
                     self._tip is not None and self._tip.startswith("mm"))
        l = self._layer
        self._nodes.append(LayerOp(f"act{l}", "zkrelu", (self._tip,),
                                   self._shape(self._tip), layer=l))
        self._tip = f"act{l}"
        return self

    def residual(self, to) -> "GraphBuilder":
        """tip := tip + act{to}; `to` is an activation layer index or a
        node name of an earlier zkrelu / residual node."""
        self._expect("residual() must follow relu()",
                     self._tip is not None and self._tip.startswith("act"))
        src = f"act{to}" if isinstance(to, int) else str(to)
        self._expect(f"residual target {src!r} must be an earlier node",
                     any(n.name == src for n in self._nodes))
        self._expect(
            f"residual shapes differ: {self._shape(self._tip)} vs "
            f"{self._shape(src)}", self._shape(self._tip) == self._shape(src))
        self._n_res += 1
        name = f"res{self._n_res}"
        self._nodes.append(LayerOp(name, "residual_add", (self._tip, src),
                                   self._shape(self._tip), layer=self._layer))
        self._tip = name
        return self

    def output(self) -> LayerGraph:
        self._expect("output() must follow relu()",
                     self._tip is not None and self._tip.startswith("act"))
        self._expect("graph needs >= 2 layers (eq. 33)", self._layer >= 2)
        self._nodes.append(LayerOp("loss", "output_grad", (self._tip,),
                                   self._shape(self._tip), layer=self._layer))
        return LayerGraph(tuple(self._nodes))

def graph_skips(graph: LayerGraph) -> Dict[int, int]:
    """Recover the matmul-layer -> skip-source-layer map of a (possibly
    residual) chain-backbone graph — the shape quantfc's witness
    generator consumes.

    Raises for NESTED residual sums: the IR validates them (and the
    claim routing handles them), but quantfc's chain emitter only
    computes single-level skips, so silently flattening one would
    produce witnesses inconsistent with the graph's claim routing."""
    out: Dict[int, int] = {}
    for n in graph.nodes:
        if n.kind == "qmatmul":
            src = graph.node(n.inputs[0])
            if src.kind == "residual_add":
                tip, skip = (graph.node(s) for s in src.inputs)
                if tip.kind != "zkrelu" or skip.kind != "zkrelu":
                    raise ValueError(
                        f"{src.name}: nested residual_add producers are "
                        "valid IR but quantfc's witness emitter supports "
                        "single-level skips only (both producers must be "
                        "zkrelu nodes)")
                out[n.layer] = skip.layer
    return out


def graph_widths(graph: LayerGraph) -> Tuple[int, ...]:
    """The chain shape table d_0..d_L of a graph (input width, then one
    out-width per qmatmul layer, in layer order)."""
    mms = sorted((n for n in graph.nodes if n.kind == "qmatmul"),
                 key=lambda n: n.layer)
    return (graph.input_node.shape[1],) + tuple(n.shape[1] for n in mms)


PROOF_GRAPH_BUILDERS: Dict[str, Callable[..., LayerGraph]] = {
    "fcnn": build_fcnn_graph,
}


def proof_graph_for_family(family: str, **kwargs) -> LayerGraph:
    """Launch-time lookup: model family -> proof graph builder."""
    try:
        builder = PROOF_GRAPH_BUILDERS[family]
    except KeyError:
        raise LookupError(
            f"no proof graph registered for family {family!r}; provable "
            f"families: {sorted(PROOF_GRAPH_BUILDERS)} (register a builder "
            "in repro_torch.core.pipeline.graph.PROOF_GRAPH_BUILDERS)") from None
    return builder(**kwargs)
