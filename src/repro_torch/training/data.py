"""Synthetic deterministic data pipeline.

Produces next-token-prediction batches with a fixed per-step seed so a
restarted run consumes byte-identical data from any step — the property
checkpoint/restart tests assert.  The "corpus" is a Zipfian token stream
with short-range structure (repeated n-grams) so losses actually decrease
during the example runs.

A copy of the JAX package's ``training/data.py`` (numpy only): its batches
are byte-identical to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import LOSS_IGNORE, NUM_FRONTEND_POSITIONS


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    frontend: str = "none"
    d_model: int = 0              # for frontend embedding stubs


def batch_at_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic batch for a given step (restart-safe)."""
    rng = np.random.default_rng((cfg.seed, step))
    B, S = cfg.global_batch, cfg.seq_len
    # zipfian unigrams, clipped into vocab
    base = rng.zipf(cfg.zipf_a, size=(B, S + 1))
    tokens = (base % (cfg.vocab_size - 2)) + 1
    # inject learnable bigram structure: token 2k followed by 2k+1
    even = (tokens[:, :-1] % 2 == 0)
    tokens[:, 1:][even] = np.minimum(tokens[:, :-1][even] + 1,
                                     cfg.vocab_size - 1)
    inputs = tokens[:, :S].astype(np.int32)
    labels = tokens[:, 1:S + 1].astype(np.int32)
    out = {"tokens": inputs, "labels": labels}
    if cfg.frontend != "none":
        P = min(NUM_FRONTEND_POSITIONS, S // 4)
        out["frontend_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32) * 0.02
        out["labels"][:, :P] = LOSS_IGNORE
    return out


def make_iterator(cfg: DataConfig, start_step: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at_step(cfg, step)
        step += 1


def for_arch(arch: ArchConfig, seq_len: int, global_batch: int,
             seed: int = 0) -> DataConfig:
    return DataConfig(vocab_size=arch.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed,
                      frontend="none" if arch.frontend == "none"
                      else arch.frontend, d_model=arch.d_model)
