"""Per-tensor backward-time estimation (paper §5.1) for the planner.

Port of ``analytic_tb`` and ``measured_tb`` from ``repro.core.profiler``.
``analytic_tb`` is the reference's roofline-style estimate with its TPU v5e
priors, so that plans stay bit-equal to the reference's: a parameter tensor
of p elements touched by B tokens costs
``max(4*B*p / (MFU * peak_flops), 3*p*bytes / hbm_bw)``.  Only relative
magnitudes matter to the planner.  Measured per-tensor times on the card
come with the measured-cost loop.
"""

from __future__ import annotations

from typing import Callable, Mapping

from repro_torch.core.bucketer import LeafMeta
from repro_torch.core.cost_model import HBM_BW, PEAK_FLOPS_BF16


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
