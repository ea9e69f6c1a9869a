"""Shape stand-ins for every model input: tensors on the ``meta``
device (shapes and dtypes, no memory), the dry run's raw material (the
reference's `repro.launch.specs`, whose leaves are
``jax.ShapeDtypeStruct``).

The shape grid assigned to this paper:
    train_4k     seq_len=4096   global_batch=256   (train_step)
    prefill_32k  seq_len=32768  global_batch=32    (prefill_step)
    decode_32k   seq_len=32768  global_batch=128   (decode_step, KV=32k)
    long_500k    seq_len=524288 global_batch=1     (decode; SSM/hybrid only)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

META = torch.device("meta")

SHAPE_GRID: Dict[str, Tuple[int, int, str]] = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

SUBQUADRATIC = ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch x shape) cell."""
    seq, gb, kind = SHAPE_GRID[shape_name]
    if shape_name == "long_500k" and cfg.family not in SUBQUADRATIC:
        return False, "full-attention arch: 512k dense decode is the quadratic regime this shape excludes (DESIGN.md §4)"
    return True, ""


def _dt(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int) -> Dict:
    if cfg.family == "vlm":
        return {
            "embeds": _sds((batch, seq, cfg.d_model), _dt(cfg)),
            "positions3": _sds((3, batch, seq), torch.int32),
            "labels": _sds((batch, seq), torch.int32),
        }
    if cfg.family == "encdec":
        return {
            "frames": _sds((batch, seq, cfg.d_model), _dt(cfg)),
            "tokens": _sds((batch, seq), torch.int32),
            "labels": _sds((batch, seq), torch.int32),
        }
    return {
        "tokens": _sds((batch, seq), torch.int32),
        "labels": _sds((batch, seq), torch.int32),
    }


def decode_token_specs(cfg: ModelConfig, batch: int) -> Dict:
    if cfg.family == "vlm":
        return {"token": _sds((batch, 1, cfg.d_model), _dt(cfg)),
                "positions3": _sds((3, batch, 1), torch.int32)}
    return {"token": _sds((batch,), torch.int32)}


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    return transformer.make_cache(cfg, batch, max_seq, META)


def param_specs(cfg: ModelConfig):
    return transformer.init_params(cfg, META)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """All abstract inputs for the given cell, keyed by role."""
    seq, batch, kind = SHAPE_GRID[shape_name]
    if kind == "train":
        return {"kind": "train",
                "batch": train_batch_specs(cfg, seq, batch)}
    if kind == "prefill":
        return {"kind": "prefill",
                "batch": train_batch_specs(cfg, seq, batch)}
    return {"kind": "decode",
            "cache": cache_specs(cfg, batch, seq),
            **decode_token_specs(cfg, batch),
            "pos": _sds((), torch.int32)}
