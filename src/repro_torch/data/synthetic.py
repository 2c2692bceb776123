"""Deterministic synthetic token pipeline (port of ``repro.data.synthetic``).

Batches are a pure function of (seed, step, shard), drawn with numpy
exactly as the reference draws them, so the two packages see byte-identical
tokens.  Tokens follow a Zipf-ish unigram draw with a repeated-ngram
structure so the LM loss is learnable.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    zipf_a: float = 1.2
    ngram: int = 8          # repeat period -> learnable structure
    mask_prefix: int = 0    # label-mask the first N positions (vlm stub)


def synthetic_batch(cfg: SyntheticConfig, seed: int, step: int,
                    batch: int, shard: int = 0, num_shards: int = 1) -> dict:
    """Return {tokens, labels} with shapes [batch, seq_len] (numpy)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, num_shards]))
    v = cfg.vocab_size
    base = rng.integers(1, max(2, v // 4), size=(batch, cfg.ngram))
    reps = -(-cfg.seq_len // cfg.ngram) + 1
    seq = np.tile(base, (1, reps))[:, :cfg.seq_len + 1]
    noise = rng.random((batch, cfg.seq_len + 1)) < 0.1
    seq = np.where(noise, rng.integers(0, v, size=seq.shape), seq)
    tokens = seq[:, :-1].astype(np.int32)
    labels = seq[:, 1:].astype(np.int32)
    if cfg.mask_prefix:
        labels = labels.copy()
        labels[:, :cfg.mask_prefix] = -1
    return {"tokens": tokens, "labels": labels}
