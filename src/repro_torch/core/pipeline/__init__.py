"""Layer-graph zkDL proof pipeline with FAC4DNN aggregation across
heterogeneous layers AND training steps.

Public surface (the compile -> prove -> verify lifecycle):

* `GraphBuilder` / `LayerOp` / `LayerGraph` / `OP_REGISTRY` /
  `build_fcnn_graph` / `build_residual_fcnn_graph` /
  `proof_graph_for_family`                        -- the IR (graph.py)
* `compile` / `ProvingKey` / `VerifyingKey`       -- setup (api.py)
* `ProofSession` / `prove_session` / `AggregatedProof` -- prover (session.py)
* `encode_proof` / `decode_proof` / `VerifyingKey.to_bytes` --
  the canonical byte format (proofio.py)
* `verify_bytes` / `verify` / `verify_session`    -- verifier (verifier.py)
* `PipelineConfig` / `PipelineKeys` / `make_keys` -- raw setup (config.py)
* `stack_witnesses` / `StackedWitness`            -- witness stacking

The reference package's README (src/repro/core/pipeline/README.md)
describes the lifecycle and the byte-format layout; the port keeps both
unchanged.
"""
from repro_torch.core.pipeline.api import ProvingKey, VerifyingKey, compile
from repro_torch.core.pipeline.config import (PipelineConfig, PipelineKeys,
                                        make_keys)
from repro_torch.core.pipeline.graph import (OP_REGISTRY, GraphBuilder,
                                             LayerGraph, LayerOp, OpSpec,
                                             TensorSlot, build_fcnn_graph,
                                             build_residual_fcnn_graph,
                                             graph_skips, graph_widths,
                                             proof_graph_for_family,
                                             register_op)
from repro_torch.core.pipeline.proofio import (ProofDecodeError, decode_proof,
                                         encode_proof)
from repro_torch.core.pipeline.session import (AggregatedProof, ProofSession,
                                         SessionCommitments, SessionProver,
                                         prove_session)
from repro_torch.core.pipeline.verifier import (verify, verify_bytes,
                                                verify_session)
from repro_torch.core.pipeline.witness import (StackedWitness,
                                               build_field_tables,
                                               stack_witnesses)

__all__ = [
    "GraphBuilder", "LayerOp", "LayerGraph", "OpSpec", "TensorSlot",
    "OP_REGISTRY", "register_op",
    "build_fcnn_graph", "build_residual_fcnn_graph",
    "graph_skips", "graph_widths", "proof_graph_for_family",
    "compile", "ProvingKey", "VerifyingKey",
    "PipelineConfig", "PipelineKeys", "make_keys",
    "AggregatedProof", "ProofSession", "SessionCommitments",
    "SessionProver", "prove_session",
    "encode_proof", "decode_proof", "ProofDecodeError",
    "verify", "verify_bytes", "verify_session",
    "StackedWitness", "build_field_tables", "stack_witnesses",
]
