"""qwen2-vl-2b: 28L d_model=1536 12H GQA kv=2, d_ff=8960, vocab=151936,
M-RoPE; vision frontend stubbed (precomputed patch embeddings)
[arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936,
        head_dim=128, mrope_sections=(16, 24, 24), rope_theta=1e6,
        frontend="vision", tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2vl-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        mrope_sections=(4, 2, 2), frontend="vision", remat=False)
