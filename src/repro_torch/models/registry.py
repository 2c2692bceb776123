"""Architecture registry: ``--arch <id>`` -> config + model (port of
``repro.models.registry``; qwen2-1.5b only so far)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (ModelConfig, ParallelConfig, RunConfig,
                                      SHAPES, reduced)
from repro_torch.models.transformer import LM

ARCHS = {
    "qwen2-1.5b": "qwen2_1_5b",
}


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    name: str
    cfg: ModelConfig
    parallel: ParallelConfig
    microbatch: dict
    skip_shapes: dict
    optimizer_state_dtype: str = "float32"

    def model(self, parallel: ParallelConfig | None = None) -> LM:
        return LM(self.cfg, parallel or self.parallel)

    def run_config(self, shape_name: str,
                   parallel: ParallelConfig | None = None) -> RunConfig:
        return RunConfig(
            model=self.cfg,
            shape=SHAPES[shape_name],
            parallel=parallel or self.parallel,
            microbatch=self.microbatch.get(shape_name, 0),
            optimizer_state_dtype=self.optimizer_state_dtype,
        )


def get_arch(name: str) -> ArchBundle:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return ArchBundle(
        name=name,
        cfg=mod.CONFIG,
        parallel=mod.PARALLEL,
        microbatch=mod.MICROBATCH,
        skip_shapes=mod.SKIP_SHAPES,
        optimizer_state_dtype=getattr(mod, "OPTIMIZER_STATE_DTYPE",
                                      "float32"),
    )


def reduced_arch(name: str, **kw) -> ArchBundle:
    """Same-family reduced config for CPU smoke tests."""
    b = get_arch(name)
    small = reduced(b.cfg, **kw)
    par = dataclasses.replace(b.parallel, ep_axis="", attn_chunk=64)
    return dataclasses.replace(b, cfg=small, parallel=par)
