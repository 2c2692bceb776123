"""AdamW and SGD-momentum (port of ``repro.optim.optimizers``).

The update is leafwise, like the reference's, but it runs in place under
``torch.no_grad``: parameters and moments are updated where they live
rather than rebuilt, which saves a copy of the model state per step.  The
arithmetic follows the reference's (float32 math, a cast back to the
parameter dtype), so the port's parameters track the reference's within
float32 rounding.

``flat_update`` is the same update on a flat packed ZeRO-1 shard, where
weight decay is a per-element 0/1 mask (``_no_decay`` per leaf, zero on
slot and shard padding) instead of a per-leaf flag.  Each factory builds
both from one hyperparameter closure, with the same operations in the
same order, so a decayed element gets the same bits on either path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.utils import tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init_leaf: Callable          # param -> state dict of tensors
    update_leaf: Callable        # (g, p, state, step, lr, decay) -> None
    weight_decay_mask: Callable  # path -> bool (True = decay applies)
    # (g32, p, state, step, lr, decay_mask) -> None: the in-place update of
    # a flat ZeRO-1 shard; decay_mask is 0/1 (float or bool) per element
    flat_update: Callable = None
    hyperparams: tuple[tuple[str, float], ...] = ()

    def init(self, params):
        return tree.tree_map(self.init_leaf, params)

    @torch.no_grad()
    def update(self, grads, params, state, step: int, lr: float) -> None:
        """Update ``params`` and ``state`` in place from ``grads``.

        Weight decay applies to every leaf, norms and biases included, as
        the reference's tree update applies it; ``weight_decay_mask`` is
        for the packed ZeRO-1 update (:attr:`flat_update`)."""
        by_path = dict(tree.flatten_with_path(grads))
        st = dict(_state_leaves(state))
        for path, p in tree.flatten_with_path(params):
            self.update_leaf(by_path[path], p, st[path], step, lr)


def _state_leaves(state):
    """(param path, state dict) pairs: the state tree mirrors the params
    with a dict of moments at each leaf."""
    out = {}
    for path, t in tree.flatten_with_path(state):
        base, _, key = path.rpartition("[")
        out.setdefault(base, {})[key[1:-2]] = t
    return out.items()


def _no_decay(path: str) -> bool:
    # norms / biases / scalar gains exempt from weight decay
    for token in ("norm", "bias", "b_q", "b_k", "b_v", "b_up", "b_down",
                  "scale", "A_log", "dt_bias", "b_gates", "b_if"):
        if token in path:
            return False
    return True


def _f32(x: float) -> float:
    return float(np.float32(x))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01, state_dtype: str = "float32"
          ) -> Optimizer:
    sdt = getattr(torch, state_dtype)

    def init_leaf(p):
        return {"m": torch.zeros(p.shape, dtype=sdt, device=p.device),
                "v": torch.zeros(p.shape, dtype=sdt, device=p.device)}

    def step_leaf(g, p, s, step, lr, decay):
        """``decay``: the weight-decay factor, a float or a per-element
        tensor (``mask * weight_decay``, exactly 0 or weight_decay)."""
        g32 = g.float()
        # float32 moments are updated in place (.float() returns them)
        m = s["m"].float().mul_(b1).add_(g32 * (1 - b1))
        v = s["v"].float().mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
        t = np.float32(step) + np.float32(1.0)
        bc1 = _f32(np.float32(1) - np.float32(b1) ** t)
        bc2 = _f32(np.float32(1) - np.float32(b2) ** t)
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        p32 = p.float()
        if isinstance(decay, torch.Tensor) or decay:
            upd.add_(p32 * decay)
        p.copy_(p32.sub_(upd * lr))
        if m is not s["m"]:
            s["m"].copy_(m)
            s["v"].copy_(v)

    def update_leaf(g, p, s, step, lr, decay=True):
        step_leaf(g, p, s, step, lr, weight_decay if decay else 0.0)

    def flat_update(g, p, s, step, lr, decay_mask):
        step_leaf(g, p, s, step, lr,
                  decay_mask * weight_decay if weight_decay else 0.0)

    return Optimizer("adamw", init_leaf, update_leaf, _no_decay, flat_update,
                     (("b1", b1), ("b2", b2), ("eps", eps),
                      ("weight_decay", weight_decay)))


def sgdm(momentum: float = 0.9, weight_decay: float = 0.0,
         state_dtype: str = "float32") -> Optimizer:
    sdt = getattr(torch, state_dtype)

    def init_leaf(p):
        return {"mu": torch.zeros(p.shape, dtype=sdt, device=p.device)}

    def step_leaf(g, p, s, step, lr, decay):
        g32 = g.float()
        p32 = p.float()
        if isinstance(decay, torch.Tensor) or decay:
            g32 = g32 + p32 * decay
        mu = s["mu"].float().mul_(momentum).add_(g32)
        p.copy_(p32.sub_(mu * lr))
        if mu is not s["mu"]:
            s["mu"].copy_(mu)

    def update_leaf(g, p, s, step, lr, decay=True):
        step_leaf(g, p, s, step, lr, weight_decay if decay else 0.0)

    def flat_update(g, p, s, step, lr, decay_mask):
        step_leaf(g, p, s, step, lr,
                  decay_mask * weight_decay if weight_decay else 0.0)

    return Optimizer("sgdm", init_leaf, update_leaf, _no_decay, flat_update,
                     (("momentum", momentum), ("weight_decay", weight_decay)))


def make_optimizer(name: str, *, weight_decay: float = 0.01,
                   state_dtype: str = "float32", b1: float = 0.9,
                   b2: float = 0.95, eps: float = 1e-8,
                   momentum: float = 0.9) -> Optimizer:
    if name == "adamw":
        return adamw(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                     state_dtype=state_dtype)
    if name == "sgdm":
        return sgdm(momentum=momentum, weight_decay=weight_decay,
                    state_dtype=state_dtype)
    raise ValueError(f"unknown optimizer {name!r}")
