"""Host-sharded data pipeline (port of ``repro.data.pipeline.batch_at``).

Each rank materializes only its shard of the global batch.  The pipeline
is stateless: ``batch_at(step)`` is a pure function of the step.  Only the
token stream is ported; the modality-frontend embeddings (encoder-decoder
and vision configs) come with those model families.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.synthetic import SyntheticConfig, synthetic_batch


class DataPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 batch_override: int = 0, shard: int = 0,
                 num_shards: int = 1):
        if cfg.enc_dec or cfg.frontend:
            raise NotImplementedError(
                f"{cfg.name}: frontend embeddings are not ported yet "
                f"(ROADMAP queue 1, item 10)")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.batch = batch_override or shape.global_batch
        self.shard = shard
        self.num_shards = num_shards
        self.syn = SyntheticConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
            mask_prefix=cfg.frontend_prefix_len)

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for ``step``: int32 CPU tensors, the same
        bytes as the reference's batch."""
        b = synthetic_batch(self.syn, self.seed, step, self.batch,
                            self.shard, self.num_shards)
        return {"tokens": torch.from_numpy(b["tokens"]),
                "labels": torch.from_numpy(b["labels"])}
