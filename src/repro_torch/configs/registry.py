"""Architecture registry of the port: ``--arch <id>`` resolves here,
with the reference's module names and aliases (`repro.configs.registry`)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "mamba2_2p7b",
    "qwen3_0p6b",
    "internlm2_1p8b",
    "starcoder2_15b",
    "deepseek_7b",
    "grok1_314b",
    "deepseek_v2_lite_16b",
    "zamba2_2p7b",
    "seamless_m4t_medium",
    "qwen2_vl_2b",
    "fcnn_zkdl_16l",          # the paper's own architecture
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen3-0.6b": "qwen3_0p6b",
    "internlm2-1.8b": "internlm2_1p8b",
    "starcoder2-15b": "starcoder2_15b",
    "deepseek-7b": "deepseek_7b",
    "grok-1-314b": "grok1_314b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-2.7b": "zamba2_2p7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "fcnn-zkdl-16l": "fcnn_zkdl_16l",
})


def _module(name: str):
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise LookupError(f"unknown architecture {name!r}; known: "
                          f"{sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str, **overrides) -> ModelConfig:
    """The config of architecture ``name`` (module name or alias), with
    ``overrides`` applied.  Raises LookupError for an unknown name."""
    cfg = _module(name).get_config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke_config()
