"""The top MLP of DLRM (Naumov et al., arXiv:1906.00091) at the Criteo
Terabyte settings of github.com/facebookresearch/dlrm
(`bench/dlrm_s_criteo_terabyte.sh`: ``--arch-sparse-feature-size=128``,
``--arch-mlp-bot=13-512-256-128``, ``--arch-mlp-top=1024-1024-512-256-1``,
``--mini-batch-size=2048``; MLPerf Training's DLRM used the same MLPs).

Its input is the dot interaction of the 26 embeddings and the bottom
MLP's output: 128 + 27 * 26 / 2 = 479 features.  Five dense layers of
widths 479-1024-1024-512-256-1, proven as zkDL's quantised FCNN
(`QuantConfig(16, 8)`): ReLU on every layer (the source's last is a
sigmoid), no biases, the square-loss output gradient; the interaction
vector is the committed input, so embeddings, the bottom MLP and the
interaction stay outside the proof.  Train it with ``--global-batch
512`` (the source's 2048 does not fit one card's merged opening)."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="dlrm-top-mlp-criteo1tb", family="fcnn", n_layers=5,
        d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0, vocab=0, head_dim=1,
        act="relu", remat=False, tie_embeddings=False,
        widths=(479, 1024, 1024, 512, 256, 1))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dlrm-top-mlp-smoke", family="fcnn", n_layers=5, d_model=16,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=0, head_dim=1,
        act="relu", remat=False, tie_embeddings=False,
        widths=(7, 16, 16, 8, 4, 1))
