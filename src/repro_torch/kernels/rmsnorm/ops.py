"""Fused RMSNorm over any leading dims (port of
``repro.kernels.rmsnorm.ops``).  The CUDA kernel reads the rows in place,
so there is no reshape, no row padding and no ``block_rows``."""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel as K


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    """x: [..., D]; scale: [D] -> [..., D] in x's dtype."""
    return K.rmsnorm_rows(x, scale, eps)
