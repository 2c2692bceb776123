"""Parameters and KV caches between the reference and the port, as numpy.

The reference's parameter pytree, flattened to ``{keystr path: array}``,
becomes the port's parameter tree and back; a KV cache (bf16 or f32 k/v,
int32 ``slot_pos``) travels the same way, so a cache primed by one package
can feed the other's ``decode_step``.  The path strings are the
same in both packages, so one :class:`~repro_torch.core.planner.MergePlan`
indexes the same tensors on either side.  numpy has no bfloat16 of its
own: bfloat16 leaves travel as float32 (exact) unless the caller's array
already has a bfloat16 dtype.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import bucketer
from repro_torch.utils import tree


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))           # a copy the port owns
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda"):
    """``{keystr path: array}`` -> the port's parameter tree on ``device``."""
    return tree.from_paths({p: _to_torch(a, device)
                            for p, a in arrays.items()})


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The port's parameter tree -> ``{keystr path: array}`` in the
    bucketer's backward (``leaf_metadata``) order; bfloat16 becomes
    float32."""
    return {path: _to_numpy(t)
            for path, t in bucketer.leaves_in_backward_order(params)}


def cache_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda"):
    """``{keystr path: array}`` of a KV cache (``[0]['blk00']['k']`` ...)
    -> the port's cache: a list of ``{"blk00": {"k", "v", "slot_pos"}}``.
    Arrays keep their dtype: bfloat16 (as ``np.asarray`` gives it from a
    JAX array), float32 and int32."""
    root = tree.from_paths({"['c']" + p: _to_torch(a, device)
                            for p, a in arrays.items()})
    return root["c"]


def cache_to_numpy(cache) -> dict[str, np.ndarray]:
    """The port's cache -> ``{keystr path: array}`` in flatten order;
    bfloat16 becomes float32 (exact), ``slot_pos`` stays int32."""
    return {path: _to_numpy(t) for path, t in tree.flatten_with_path(cache)}
