"""Per-tensor backward-time estimation (paper §5.1) for the planner.

Port of ``repro.core.profiler``.  Two sources of ``t_b``:

* ``analytic_tb`` — the reference's roofline-style estimate with its TPU
  v5e priors, kept so that plans stay bit-equal to the reference's: a
  parameter tensor of p elements touched by B tokens costs
  ``max(4*B*p / (MFU * peak_flops), 3*p*bytes / hbm_bw)``.  Only relative
  magnitudes matter to the planner.
* ``measure_loss_profile`` — real timings of one model on its device:
  the forward under ``torch.no_grad()`` and the forward plus backward,
  each after warm-up (the first calls carry cuBLAS set-up), with a
  device synchronize after every timed call on the card.  The backward
  share is split over the tensors by element count
  (``distribute_block_times``).

The backward is taken with ``torch.autograd.grad`` on detached copies of
the inputs, never with ``.backward()``: it writes no ``.grad`` (the train
step's bucket member tables point at those storages) and fires none of
the post-accumulate-grad hooks that issue the train step's buckets.
"""

from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

import torch

from repro_torch.core.bucketer import LeafMeta
from repro_torch.core.cost_model import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.utils import tree


def analytic_tb(tokens_per_device: int, *, mfu: float = 0.5,
                peak_flops: float = PEAK_FLOPS_BF16, hbm_bw: float = HBM_BW,
                matmul_min_elems: int = 1 << 16) -> Callable[[LeafMeta], float]:
    """Build a ``LeafMeta -> t_b seconds`` function.

    Tensors with >= ``matmul_min_elems`` elements are treated as matmul
    weights (compute-bound at scale); smaller tensors (biases, norm scales)
    are bandwidth-bound.
    """
    if tokens_per_device <= 0:
        raise ValueError("tokens_per_device must be positive")

    def t_b(meta: LeafMeta) -> float:
        p = meta.size
        bw_time = 3.0 * meta.nbytes / hbm_bw
        if p >= matmul_min_elems:
            flop_time = 4.0 * tokens_per_device * p / (mfu * peak_flops)
            return max(flop_time, bw_time)
        return bw_time

    return t_b


def measured_tb(table: Mapping[str, float],
                fallback: Callable[[LeafMeta], float]
                ) -> Callable[[LeafMeta], float]:
    """``LeafMeta -> t_b`` from a measured per-tensor table with an analytic
    prior for unmeasured tensors."""
    def t_b(meta: LeafMeta) -> float:
        v = float(table.get(meta.path, 0.0))
        return v if v > 0.0 else fallback(meta)
    return t_b


def _timed(fn: Callable[[], object], device: torch.device, n_warmup: int,
           n_iters: int) -> float:
    """Mean wall seconds of ``fn()`` over ``n_iters`` calls, after one
    untimed first call and ``n_warmup`` more; on the card every call ends
    in a device synchronize."""
    def call():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(1 + n_warmup):
        call()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        call()
    return (time.perf_counter() - t0) / n_iters


def _device_of(args) -> torch.device:
    for leaf in tree.leaves(args):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _with_grad_inputs(args):
    """``args`` with every floating tensor replaced by a detached copy that
    requires grad (same storage, no ``.grad``, no hooks), and the list of
    those copies."""
    inputs = []

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            x = x.detach().requires_grad_(True)
            inputs.append(x)
        return x

    return tree.tree_map(leaf, args), inputs


def measure_backward_times(block_fns: Sequence[Callable], args_per_block,
                           n_warmup: int = 1, n_iters: int = 3) -> list[float]:
    """Wall time of each block's VJP (forward + backward), in seconds per
    block, forward order.

    ``block_fns[i]`` maps ``*args_per_block[i]`` to its output tree; the
    VJP takes the gradient of every output that requires grad, with a
    cotangent of ones, with respect to every floating tensor in the
    arguments, through ``torch.autograd.grad``.
    """
    times = []
    for fn, args in zip(block_fns, args_per_block):
        g_args, inputs = _with_grad_inputs(tuple(args))

        def vjp(fn=fn, g_args=g_args, inputs=inputs):
            outs = [o for o in tree.leaves(fn(*g_args))
                    if isinstance(o, torch.Tensor) and o.requires_grad]
            if not outs:
                raise ValueError("the block's output does not depend on a "
                                 "floating tensor argument")
            torch.autograd.grad(outs, inputs,
                                [torch.ones_like(o) for o in outs],
                                allow_unused=True)

        times.append(_timed(vjp, _device_of(args), n_warmup, n_iters))
    return times


def distribute_block_times(block_times: Sequence[float],
                           metas_per_block: Sequence[Sequence[LeafMeta]]
                           ) -> list[float]:
    """Split measured per-block time across the block's tensors, weighted by
    element count (backward order within the block)."""
    out = []
    for t, metas in zip(block_times, metas_per_block):
        total = sum(m.size for m in metas) or 1
        out.extend(t * m.size / total for m in metas)
    return out


def measure_loss_profile(loss_fn: Callable, args: tuple,
                         metas: Sequence[LeafMeta], *, n_warmup: int = 1,
                         n_iters: int = 3) -> tuple[float, dict[str, float]]:
    """Real timings for one model: ``(t_f, {path: t_b})``.

    Times ``loss_fn(*args)`` under ``torch.no_grad()`` and its full VJP
    (:func:`measure_backward_times`) on the same arguments; the backward
    share (VJP minus forward, floored at a tenth of the VJP so that a
    noisy host never hands the planner a zero profile) is distributed
    over ``metas`` by element count.  On several ranks each measures its
    own table: agree on one before planning, or the ranks plan different
    buckets.
    """
    def fwd():
        with torch.no_grad():
            loss_fn(*args)

    t_f = _timed(fwd, _device_of(args), n_warmup, n_iters)
    t_vjp = measure_backward_times([loss_fn], [args], n_warmup=n_warmup,
                                   n_iters=n_iters)[0]
    t_b_total = max(t_vjp - t_f, 0.1 * t_vjp)
    per = distribute_block_times([t_b_total], [list(metas)])
    return t_f, {m.path: t for m, t in zip(metas, per)}
