"""deepseek-7b: 30L d_model=4096 32H (kv=32, i.e. MHA), d_ff=11008,
vocab=102400, llama-arch [arXiv:2401.02954]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=11008, vocab=102400,
        head_dim=128, rope_theta=1e4, tie_embeddings=False, fsdp=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
        tie_embeddings=False, remat=False)
