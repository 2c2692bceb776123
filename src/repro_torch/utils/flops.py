"""MODEL_FLOPS accounting: 6·N·D for training, 2·N·D for prefill and
decode (port of ``repro.utils.flops`` for the dense models the port has).

N counts the parameters touched per token; attention's O(S²) flops are
left out, per the 6ND convention.  The trees may live on the ``meta``
device: only shapes are read.
"""

from __future__ import annotations

import re

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.utils import tree


def param_counts(params) -> tuple[int, int]:
    """(total_params, active_params) of a tensor tree; the caller corrects
    active for expert leaves."""
    total = sum(t.numel() for t in tree.leaves(params))
    return total, total


def model_flops(cfg: ModelConfig, params, shape: ShapeConfig,
                kind: str) -> dict:
    """Returns {total_params, active_params, tokens, model_flops}."""
    total = expert = 0
    for path, t in tree.flatten_with_path(params):
        total += t.numel()
        if re.search(r"w_(gate|up|down)_e", path):
            expert += t.numel()
    active = total - expert
    if cfg.moe is not None and expert:
        active += expert * cfg.moe.top_k / cfg.moe.num_experts
    if kind == "train":
        tokens, factor = shape.global_batch * shape.seq_len, 6.0
    elif kind == "prefill":
        tokens, factor = shape.global_batch * shape.seq_len, 2.0
    else:  # decode: one token per sequence
        tokens, factor = shape.global_batch, 2.0
    return {
        "total_params": int(total),
        "active_params": int(active),
        "tokens": int(tokens),
        "model_flops": factor * active * tokens,
    }
