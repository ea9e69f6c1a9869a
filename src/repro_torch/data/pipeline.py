"""Deterministic sharded data pipeline.

Two sources behind one interface:
  * ``SyntheticTokens`` -- counter-based PRNG stream (step, rank) ->
    tokens, so any (step) batch is reproducible on any topology;
  * ``BinTokenFile`` -- memory-mapped flat token file (the production
    path), sliced per (step, dp_rank) without overlap.

Determinism across restarts: the batch for step N depends only on N (and
the file), never on consumed state -- resume needs no data checkpointing
beyond the step counter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SyntheticTokens:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed + step))
        b, s, cfg = self.global_batch, self.seq_len, self.cfg
        if cfg.family == "vlm":
            return {
                "embeds": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
                "positions3": np.broadcast_to(
                    np.arange(s, dtype=np.int32), (3, b, s)).copy(),
                "labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
            }
        if cfg.family == "encdec":
            return {
                "frames": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
                "labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
            }
        toks = rng.integers(0, cfg.vocab, (b, s + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


@dataclasses.dataclass
class BinTokenFile:
    """Flat binary token file (uint16/uint32), deterministic slicing."""
    path: str
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._tokens_per_step = self.global_batch * (self.seq_len + 1)
        self.n_steps = len(self._data) // self._tokens_per_step

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        step = step % max(self.n_steps, 1)
        off = step * self._tokens_per_step
        chunk = np.asarray(
            self._data[off: off + self._tokens_per_step], dtype=np.int32)
        chunk = chunk.reshape(self.global_batch, self.seq_len + 1)
        chunk = np.remainder(chunk, self.cfg.vocab)
        return {"tokens": chunk[:, :-1].copy(), "labels": chunk[:, 1:].copy()}


def make_source(cfg: ModelConfig, seq_len: int, global_batch: int,
                path: Optional[str] = None, seed: int = 0):
    if path:
        return BinTokenFile(path, cfg, seq_len, global_batch)
    return SyntheticTokens(cfg, seq_len, global_batch, seed)
