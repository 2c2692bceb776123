"""Global-norm gradient clipping (port of ``repro.optim.clip``).

The norm stays on the device as a 0-d float32 tensor and the scaling runs
in place, so clipping needs no host synchronisation.
"""

from __future__ import annotations

import torch

from repro_torch.utils import tree


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in float32."""
    leaves = tree.leaves(grads)
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float,
                        norm: torch.Tensor | None = None):
    """Scale ``grads`` in place by ``min(1, max_norm / norm)``; returns
    ``(grads, norm)``."""
    n = norm if norm is not None else global_norm(grads)
    if max_norm <= 0:
        return grads, n
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    torch._foreach_mul_(tree.leaves(grads), scale)
    return grads, n
