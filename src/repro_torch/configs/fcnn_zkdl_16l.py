"""The paper's own architecture: 16-layer FCNN, width 4096 (CIFAR-10
padded), 268M params, batch 128 -- the Section 5 experiment scale.
This config drives the zkDL verifiable-training path."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="fcnn-zkdl-16l", family="fcnn", n_layers=16, d_model=4096,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=0, head_dim=1,
        act="relu", remat=False, tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="fcnn-smoke", family="fcnn", n_layers=3, d_model=16,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=0, head_dim=1,
        act="relu", remat=False, tie_embeddings=False)
