"""Model configuration covering all assigned architecture families
(the reference's `repro.models.config`, kept as the port's own copy)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # -- attention options ---------------------------------------------------
    act: str = "silu"            # silu | gelu | relu
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim split
    causal: bool = True

    # -- MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense: int = 0         # leading dense layers before MoE layers
    capacity_factor: float = 1.25

    # -- MLA (deepseek-v2) ------------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- SSM (mamba2) -------------------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_every: int = 0          # hybrid: shared attn block period (zamba2)

    # -- encoder-decoder ----------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    frontend: str = "none"       # none | audio | vision (stub: embeddings in)

    # -- training -------------------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save matmul outputs)
    seq_shard_carry: bool = False  # Megatron-SP: S-shard the residual carry
    # blockwise-attention sharding anchor: "auto" applies it when the kv
    # dim divides the model axis (always a win); "on" forces it even when
    # that means replicating heads once per layer (wins for wide archs
    # like starcoder2 where SPMD otherwise re-gathers inside the kv loop;
    # loses for small archs -- EXPERIMENTS.md §Perf); "off" disables.
    blockwise_anchor: str = "auto"
    scan_layers: bool = True     # False: unroll blocks (costmodel validation)
    tie_embeddings: bool = True

    # -- distribution hints (overridable by the launcher) -----------------------------
    fsdp: bool = False           # shard weights over the data axis too

    # -- provable families -----------------------------------------------------------
    # the shape table d_0..d_L of a network of mixed widths; empty: every
    # layer d_model wide
    widths: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per = (d * (2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state
                        + self.ssm_nheads)
                   + self.d_inner * d + 2 * d)
            return emb + self.n_layers * per
        if self.mla:
            attn = (d * (self.n_heads * (self.qk_nope_dim + self.qk_rope_dim))
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = (d * self.n_heads * self.head_dim
                    + 2 * d * self.n_kv_heads * self.head_dim
                    + self.n_heads * self.head_dim * d)
        dense_ff = 3 * d * self.d_ff
        if self.is_moe:
            moe_ff = (self.n_experts + self.n_shared_experts) * 3 * d * self.moe_d_ff
            n_moe = self.n_layers - self.first_dense
            ff_total = self.first_dense * dense_ff + n_moe * moe_ff
            router = n_moe * d * self.n_experts
        else:
            layers = (self.enc_layers + self.dec_layers
                      if self.family == "encdec" else self.n_layers)
            ff_total = layers * dense_ff
            router = 0
        layers = (self.enc_layers + self.dec_layers
                  if self.family == "encdec" else self.n_layers)
        cross = layers // 2 * attn if self.family == "encdec" else 0
        if self.family == "hybrid":
            per_ssm = (d * (2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state
                            + self.ssm_nheads) + self.d_inner * d)
            shared = attn + dense_ff
            return emb + self.n_layers * per_ssm + shared
        return emb + layers * (attn + 2 * d) + ff_total + router + cross

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top_k experts count)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_ff = (self.n_layers - self.first_dense) * self.n_experts * 3 * d * self.moe_d_ff
        act_ff = ((self.n_layers - self.first_dense)
                  * (self.top_k + self.n_shared_experts) * 3 * d * self.moe_d_ff)
        return full - all_ff + act_ff
