"""Flash attention on ``[B, S, H, D]`` (port of
``repro.kernels.flash_attention.ops``).  The CUDA kernel reads the
``[B, S, H, D]`` layout through strides and masks the ragged edge itself,
so there is no transpose, no padding and no ``block_q``/``block_k``."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D] -> [B, Sq, Hq, D].
    Raises ``ValueError`` unless Hq is a multiple of Hkv."""
    return K.flash_attention_bshd(q, k, v, causal=causal, window=window)
