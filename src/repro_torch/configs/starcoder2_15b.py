"""starcoder2-15b: 40L d_model=6144 48H GQA kv=4, d_ff=24576, vocab=49152,
RoPE [arXiv:2402.19173]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152,
        head_dim=128, act="gelu", rope_theta=1e5, tie_embeddings=True,
        fsdp=True,
        # kv=4 does not divide the 16-way model axis, but pinning the
        # heads replicated up-front still beats SPMD's in-loop re-gathers
        # at this width: 55.2 s -> 15.5 s collective (EXPERIMENTS.md §Perf)
        blockwise_anchor="on")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
        act="gelu", remat=False)
