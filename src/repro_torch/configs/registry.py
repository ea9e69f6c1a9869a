"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the provable families are ported.  `ModelConfig` keeps the fields
of the reference's `repro.models.config.ModelConfig` that the
prove-while-train path reads; the reference's model zoo is ROADMAP.md
queue 1, item 16.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int


ARCHS: List[str] = [
    "fcnn_zkdl_16l",          # the paper's own architecture
]
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    """The config of architecture ``name`` (module name or dash alias).
    Raises LookupError for an architecture the port does not have."""
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise LookupError(
            f"architecture {name!r} is not ported to repro_torch; ported: "
            f"{sorted(_ALIASES)} (the other families are ROADMAP.md queue "
            "1, item 16)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}") \
        .get_config()
