"""The paper's own architecture: 16-layer FCNN, width 4096 (CIFAR-10
padded), batch 128 -- the Section 5 experiment scale (reference:
`repro/configs/fcnn_zkdl_16l.py`)."""
from repro_torch.configs.registry import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(name="fcnn-zkdl-16l", family="fcnn", n_layers=16,
                       d_model=4096)
