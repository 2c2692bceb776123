"""All-reduce cost models (paper Table 2) for the merge planner.

Port of the part of ``repro.core.cost_model`` that planning needs: the
linear model ``T(M) = a + b * M`` (paper Eq. 10), its per-link path form,
:func:`production_comm_model`, the damped update :func:`blend` and the
least-squares :func:`fit`.  The hardware constants are still the
reference's TPU v5e priors, kept unchanged so that the port's plans stay
bit-equal to the reference's.  They are priors, not measurements of the
card the port runs on: the card's own model is the one
``train.replan.measure_comm_model`` fits from timed collectives.

The key property exploited by MG-WFBP (paper Eq. 11) is super-additivity of
the startup term:

    T_ar(M1) + T_ar(M2) = 2a + b(M1+M2) > a + b(M1+M2) = T_ar(M1+M2)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# TPU v5e priors (the reference's constants; not H100 numbers).
# ---------------------------------------------------------------------------
PEAK_FLOPS_BF16 = 197e12      # per chip, FLOP/s
HBM_BW = 819e9                # per chip, B/s
ICI_BW_PER_LINK = 50e9        # B/s per ICI link
ICI_ALPHA = 1e-6              # ~1 us per-hop startup on ICI
DCN_BW = 25e9                 # B/s effective per host across pods
DCN_ALPHA = 2.5e-4            # ~250 us startup for a cross-pod collective


@dataclasses.dataclass(frozen=True)
class AllReduceModel:
    """Linear all-reduce cost model ``T(M) = a + b * M`` (Eq. 10)."""

    a: float            # startup time, seconds
    b: float            # per-byte time, seconds/byte
    name: str = "linear"

    def __post_init__(self):
        if self.a < 0 or self.b < 0:
            raise ValueError(f"negative cost model parameters: a={self.a} b={self.b}")

    def time(self, nbytes: float) -> float:
        """Cost of all-reducing a message of ``nbytes`` bytes."""
        if nbytes <= 0:
            return 0.0
        return self.a + self.b * float(nbytes)

    def merge_gain(self, nbytes_1: float, nbytes_2: float) -> float:
        """Time saved by merging two messages into one (== a; Eq. 11/21)."""
        if nbytes_1 <= 0 or nbytes_2 <= 0:
            return 0.0
        return self.time(nbytes_1) + self.time(nbytes_2) - self.time(
            nbytes_1 + nbytes_2)

    def scaled(self, factor: float) -> "AllReduceModel":
        return AllReduceModel(self.a * factor, self.b * factor, self.name)


def blend(old: AllReduceModel, new: AllReduceModel,
          weight: float) -> AllReduceModel:
    """Damped model update: ``weight`` on the new estimate, rest on the
    old.  A full-step update (weight=1) can flip between two plans whose
    observations each justify the other's model."""
    if not 0.0 <= weight <= 1.0:
        raise ValueError(f"blend weight must be in [0, 1], got {weight}")
    return AllReduceModel(old.a * (1 - weight) + new.a * weight,
                          old.b * (1 - weight) + new.b * weight,
                          new.name)


def fit(sizes_bytes: Sequence[float], times_s: Sequence[float],
        name: str = "fitted") -> AllReduceModel:
    """Least-squares fit of ``T(M) = a + b*M`` from measurements (paper
    Fig. 4).  A negative ``a`` or ``b`` (possible with noisy samples) is
    clamped to zero: it is not physical and breaks the merge logic."""
    sizes = np.asarray(sizes_bytes, dtype=np.float64)
    times = np.asarray(times_s, dtype=np.float64)
    if sizes.shape != times.shape or sizes.ndim != 1 or sizes.size < 2:
        raise ValueError("need >= 2 paired (size, time) samples")
    A = np.stack([np.ones_like(sizes), sizes], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, times, rcond=None)
    return AllReduceModel(max(float(a), 0.0), max(float(b), 0.0), name)


# ---------------------------------------------------------------------------
# Per-link path models: a multi-phase collective is a sum of per-link
# affine phases, still affine, so the planner stays exact.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PathPhase:
    """One per-link leg of a collective's path.  ``a``/``b`` are the
    phase's startup and per-byte cost of the FULL message; ``shard_fraction``
    is the share of the message's bytes that crosses the link."""

    link: str
    a: float
    b: float
    shard_fraction: float = 1.0

    def __post_init__(self):
        if self.a < 0 or self.b < 0:
            raise ValueError(f"negative phase cost: {self}")
        if not 0.0 < self.shard_fraction <= 1.0:
            raise ValueError(
                f"shard_fraction must be in (0, 1]: {self}")


@dataclasses.dataclass(frozen=True)
class PathModel:
    """An ordered sequence of per-link affine phases; ``flatten()`` gives
    the single ``(a, b)`` the MG-WFBP DP consumes."""

    phases: tuple[PathPhase, ...]
    name: str = "path"

    def __post_init__(self):
        object.__setattr__(self, "phases", tuple(self.phases))
        if not self.phases:
            raise ValueError("a path needs >= 1 phase")

    @property
    def a(self) -> float:
        acc = 0.0
        for p in self.phases:
            acc += p.a
        return acc

    @property
    def b(self) -> float:
        acc = 0.0
        for p in self.phases:
            acc += p.b
        return acc

    def flatten(self) -> AllReduceModel:
        return AllReduceModel(self.a, self.b, self.name)

    def time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.a + self.b * float(nbytes)


def as_linear(model) -> AllReduceModel:
    """Normalize a cost model to the flat (a, b) view the DP consumes
    (an :class:`AllReduceModel` passes through unchanged)."""
    if isinstance(model, AllReduceModel):
        return model
    if isinstance(model, HierarchicalModel):
        return model.flat()
    if hasattr(model, "flatten"):
        return model.flatten()
    return model


# ---------------------------------------------------------------------------
# Ring all-reduce (Table 2) and the TPU interconnect models built on it.
# ---------------------------------------------------------------------------

def ring(n: int, alpha: float, beta: float, gamma: float) -> AllReduceModel:
    """Ring all-reduce — bandwidth optimal, latency linear in N."""
    if n < 1:
        raise ValueError(f"need >= 1 workers, got {n}")
    if n == 1:
        return AllReduceModel(0.0, 0.0, "ring")
    b = 2 * (n - 1) / n * beta + (n - 1) / n * gamma
    return AllReduceModel(2 * (n - 1) * alpha, b, "ring")


def tpu_ici_ring(axis_size: int, *, bw_per_link: float = ICI_BW_PER_LINK,
                 alpha: float = ICI_ALPHA, bidirectional: bool = True,
                 gamma: float = 0.0) -> AllReduceModel:
    """Ring all-reduce over one ICI mesh axis (both directions streamed)."""
    eff_bw = bw_per_link * (2.0 if bidirectional else 1.0)
    m = ring(axis_size, alpha, 1.0 / eff_bw, gamma)
    return AllReduceModel(m.a, m.b, "tpu_ici_ring")


def tpu_dcn(pods: int, *, bw: float = DCN_BW, alpha: float = DCN_ALPHA,
            gamma: float = 0.0) -> AllReduceModel:
    """Cross-pod (DCN) all-reduce: high-latency, lower-bandwidth level."""
    m = ring(pods, alpha, 1.0 / bw, gamma)
    return AllReduceModel(m.a, m.b, "tpu_dcn")


@dataclasses.dataclass(frozen=True)
class HierarchicalModel:
    """Two-level all-reduce: reduce-scatter intra-pod, all-reduce across
    pods on the 1/intra_size shard, all-gather intra-pod.  Still linear in
    M: ``a = intra.a + inter.a``, ``b = intra.b + inter.b / intra_size``."""

    intra: AllReduceModel
    inter: AllReduceModel
    intra_size: int

    def path(self, ici_link: str = "ici", dcn_link: str = "dcn"
             ) -> PathModel:
        shard = max(self.intra_size, 1)
        return PathModel((
            PathPhase(ici_link, self.intra.a, self.intra.b),
            PathPhase(dcn_link, self.inter.a, self.inter.b / shard,
                      1.0 / shard),
        ), "hierarchical")

    @functools.cached_property
    def _default_path(self) -> PathModel:
        return self.path()

    @property
    def a(self) -> float:
        return self._default_path.a

    @property
    def b(self) -> float:
        return self._default_path.b

    @property
    def name(self) -> str:  # pragma: no cover - trivial
        return "hierarchical"

    def time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.a + self.b * float(nbytes)

    def flat(self) -> AllReduceModel:
        """Collapse to a flat linear model for the planner."""
        return self._default_path.flatten()


def production_comm_model(mesh_shape: Sequence[int],
                          mesh_axis_names: Sequence[str],
                          dp_axes: Sequence[str] = ("pod", "data"),
                          algorithm: str = "ring") -> AllReduceModel:
    """Build the gradient all-reduce cost model for a production mesh.

    Single-pod meshes use the ICI model over the data axis; multi-pod meshes
    compose ICI (data axis) with DCN (pod axis) hierarchically.
    """
    dims = dict(zip(mesh_axis_names, mesh_shape))
    data = dims.get("data", 1)
    pods = dims.get("pod", 1)
    if "data" not in dp_axes:
        data = 1
    if "pod" not in dp_axes:
        pods = 1
    intra = tpu_ici_ring(data) if data > 1 else AllReduceModel(0.0, 0.0, "noop")
    if pods <= 1:
        return AllReduceModel(intra.a, intra.b, "tpu_ici_ring")
    inter = tpu_dcn(pods)
    return HierarchicalModel(intra=intra, inter=inter, intra_size=data).flat()
