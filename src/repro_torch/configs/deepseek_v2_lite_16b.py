"""deepseek-v2-lite-16b: 27L d_model=2048 16H, MLA kv_lora=512,
MoE 64 routed top-6 + 2 shared, expert d_ff=1408, first layer dense
(d_ff=10944), vocab=102400 [arXiv:2405.04434]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", n_layers=27,
        d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
        vocab=102400, head_dim=128,
        mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        v_head_dim=128,
        n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
        first_dense=1, rope_theta=1e4, tie_embeddings=False, fsdp=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dsv2lite-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
        mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, n_experts=4, top_k=2, n_shared_experts=1,
        moe_d_ff=32, first_dense=1, tie_embeddings=False, remat=False)
