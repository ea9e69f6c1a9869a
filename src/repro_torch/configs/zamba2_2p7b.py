"""zamba2-2.7b: 54 Mamba2 layers d_model=2560 (ssm_state=64) with a
SHARED attention+MLP block (32H, d_ff=10240) applied every 6 layers
[arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
        head_dim=80, ssm_state=64, ssm_headdim=64, ssm_expand=2,
        ssm_chunk=256, attn_every=6, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
        attn_every=2, remat=False)
