"""Parameters between the reference and the port, as numpy.

The reference's parameter pytree, flattened to ``{keystr path: array}``,
becomes the port's parameter tree and back.  The path strings are the
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


def params_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda"):
    """``{keystr path: array}`` -> the port's parameter tree on ``device``."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))       # a copy the port owns
        return t.to(device)
    return tree.from_paths({p: one(a) for p, a in arrays.items()})


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """The port's parameter tree -> ``{keystr path: array}`` in the
    bucketer's backward (``leaf_metadata``) order; bfloat16 becomes
    float32."""
    out = {}
    for path, t in bucketer.leaves_in_backward_order(params):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[path] = t.numpy()
    return out
