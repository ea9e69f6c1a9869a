"""internlm2-1.8b: 24L d_model=2048 16H GQA kv=8, d_ff=8192, vocab=92544
[arXiv:2403.17297]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92544,
        head_dim=128, rope_theta=1e6, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        tie_embeddings=False, remat=False)
