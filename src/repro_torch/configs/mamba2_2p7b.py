"""mamba2-2.7b: 64L d_model=2560 attn-free, vocab=50280, ssm_state=128.
SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
        head_dim=1, ssm_state=128, ssm_headdim=64, ssm_expand=2,
        ssm_chunk=256, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=128, head_dim=1,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=16,
        remat=False)
