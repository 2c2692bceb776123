"""Training state container (port of ``repro.train.train_state``).

The port updates the state in place: the step counter is a host integer.
``grads`` is the tree of tensors the step reduces and applies: each
parameter's ``.grad``, kept allocated, or float32 accumulators under
microbatching.  ``grad_sync`` holds the hook-driven all-reduce bound to
those buffers (None when the step reduces nothing).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    step: int                  # optimizer steps taken
    params: Any                # model parameter tree
    opt_state: Any             # optimizer moments, mirroring params
    grads: Any = None          # gradient buffers, mirroring params
    grad_sync: Any = None      # core.comm.BucketedAllReduce or None

    @staticmethod
    def create(params, opt_state, grads=None, grad_sync=None):
        return TrainState(step=0, params=params, opt_state=opt_state,
                          grads=grads, grad_sync=grad_sync)
