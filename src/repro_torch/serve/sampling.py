"""Token sampling for the serving engine (port of
``repro.serve.sampling``).

``temperature`` draws from an explicit ``torch.Generator``; its draws
cannot equal ``jax.random``'s from the same seed.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: [B, V] -> [B, 1] int32, the first maximum as ``jnp.argmax``
    takes it."""
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


def temperature(logits: torch.Tensor, generator: torch.Generator,
                temp: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Sample from ``softmax(logits / temp)``, keeping the ``top_k`` largest
    logits when ``top_k`` > 0.  logits: [B, V] -> [B, 1] int32."""
    lg = logits.float() / max(temp, 1e-6)
    if top_k:
        cut = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < cut, -1e30, lg)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
