"""Learning-rate schedules (port of ``repro.optim.schedule``).

Computed on the host in float32, as the reference computes them in jnp
float32, and returned as the exact float32 value in a Python float.
"""

from __future__ import annotations

import numpy as np

_f = np.float32


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step: int) -> float:
        s = _f(step)
        if s < warmup_steps:
            return float(_f(peak_lr) * s / _f(max(warmup_steps, 1)))
        prog = np.clip((s - _f(warmup_steps)) /
                       _f(max(total_steps - warmup_steps, 1)), _f(0), _f(1))
        cos = _f(peak_lr) * (_f(final_frac) + _f((1 - final_frac) * 0.5) *
                             (_f(1) + np.cos(_f(np.pi) * prog)))
        return float(_f(cos))
    return lr
