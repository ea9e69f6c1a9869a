"""seamless-m4t-medium: encoder-decoder 12L+12L d_model=1024 16H,
d_ff=4096, vocab=256206; speech frontend stubbed (precomputed frames)
[arXiv:2308.11596]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec", n_layers=24,
        enc_layers=12, dec_layers=12, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab=256206, head_dim=64,
        frontend="audio", tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec", n_layers=4,
        enc_layers=2, dec_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, head_dim=16, frontend="audio", remat=False)
