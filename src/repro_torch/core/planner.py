"""Gradient-merge planners: the paper's Algorithm 1 plus baselines.

Port of ``repro.core.planner``; plans are bit-equal to the reference's.

Terminology bridge
------------------
The paper indexes layers ``L .. 1`` with backward propagation running from
layer L down to layer 1; a *merged-gradient layer* ``l`` postpones its
communication and merges into ``l-1`` (the tensor produced *after* it during
backward).  We index tensors in **backward production order**: index 0 is the
first gradient produced (the paper's layer L), index ``L-1`` the last (the
paper's layer 1).  A plan is then a partition of ``0..L-1`` into contiguous
*buckets*; every tensor of a bucket except the last is a merged-gradient
layer, and the bucket's all-reduce may start when

  (1) the last tensor's gradient has been produced, and
  (2) the previous bucket's all-reduce has finished           (paper Eq. 7)

Planners
--------
* ``plan_wfbp``        — one bucket per tensor (WFBP baseline, Fig. 1b).
* ``plan_single``      — one bucket for everything (SyncEASGD, Fig. 1c).
* ``plan_fixed_size``  — PyTorch-DDP style byte-capped buckets (beyond-paper
                         baseline).
* ``plan_mgwfbp``      — the paper's Algorithm 1, faithful O(L^2)
                         (reference implementation).
* ``plan_dp_optimal``  — O(L^2) dynamic program that provably minimizes the
                         final communication finish time (reference
                         implementation).
* ``Planner``          — the production fast path: the same optimal DP
                         restructured around prefix-sum recurrences and a
                         monotonic frontier so a from-scratch plan is O(L)
                         and ``Planner.update(SpecDelta)`` replans
                         incrementally (O(L log L) amortized over an update
                         stream) — cheap enough to run *inside* elastic
                         resizes and simulator sweeps.

``plan_contention_aware`` and ``dp_batched`` (the reference's simulator-
and fleet-backed planners) are not ported yet and raise.

All planners consume a list of :class:`TensorSpec` (backward order) and a
cost model exposing ``a``, ``b`` and ``time(nbytes)`` (see
``cost_model.AllReduceModel``).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Mapping, Sequence

from repro_torch.core import cost_model
from repro_torch.core.cost_model import AllReduceModel
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.recorder import EventRecord, plan_fingerprint


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """One gradient tensor as seen by the communication scheduler."""

    name: str
    nbytes: int        # bytes to all-reduce for this tensor
    t_b: float         # backward compute time that produces this gradient (s)

    def __post_init__(self):
        if self.nbytes < 0 or self.t_b < 0:
            raise ValueError(f"negative spec: {self}")


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """A partition of backward-ordered tensors into contiguous buckets."""

    buckets: tuple[tuple[int, ...], ...]
    strategy: str = "custom"

    def __post_init__(self):
        flat = [i for b in self.buckets for i in b]
        if flat != list(range(len(flat))):
            raise ValueError(
                f"buckets must be a contiguous partition of 0..L-1, got {self.buckets}")
        if any(len(b) == 0 for b in self.buckets):
            raise ValueError("empty bucket")

    @property
    def num_tensors(self) -> int:
        return sum(len(b) for b in self.buckets)

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def bucket_of(self) -> list[int]:
        """tensor index -> bucket index."""
        out = [0] * self.num_tensors
        for k, b in enumerate(self.buckets):
            for i in b:
                out[i] = k
        return out

    def merged_flags(self) -> list[bool]:
        """Per-tensor flag: True iff the tensor is a merged-gradient layer
        (i.e. NOT the last element of its bucket).  Matches the paper's
        ``m[l] == l_m`` with the index order reversed."""
        flags = []
        for b in self.buckets:
            flags.extend([True] * (len(b) - 1) + [False])
        return flags

    def bucket_bytes(self, specs: Sequence[TensorSpec]) -> list[int]:
        return [sum(specs[i].nbytes for i in b) for b in self.buckets]

    @staticmethod
    def from_boundaries(num_tensors: int, last_indices: Sequence[int],
                        strategy: str = "custom") -> "MergePlan":
        """Build from the sorted list of bucket-final tensor indices."""
        last = sorted(set(last_indices))
        if not last or last[-1] != num_tensors - 1:
            raise ValueError("final tensor must close a bucket")
        buckets, start = [], 0
        for e in last:
            buckets.append(tuple(range(start, e + 1)))
            start = e + 1
        return MergePlan(tuple(buckets), strategy)

    @staticmethod
    def from_merged_flags(flags: Sequence[bool], strategy: str = "custom") -> "MergePlan":
        last = [i for i, f in enumerate(flags) if not f]
        if flags and flags[-1]:
            # last tensor can never be merged "forward"; force it to close.
            last.append(len(flags) - 1)
        return MergePlan.from_boundaries(len(flags), last, strategy)


# ---------------------------------------------------------------------------
# Baselines.
# ---------------------------------------------------------------------------

def plan_wfbp(specs: Sequence[TensorSpec]) -> MergePlan:
    """Per-tensor communication (WFBP)."""
    return MergePlan(tuple((i,) for i in range(len(specs))), "wfbp")


def plan_single(specs: Sequence[TensorSpec]) -> MergePlan:
    """Single merged communication (SyncEASGD)."""
    return MergePlan((tuple(range(len(specs))),), "single")


def plan_fixed_size(specs: Sequence[TensorSpec], cap_bytes: int) -> MergePlan:
    """PyTorch-DDP-style bucketing: close a bucket once it reaches cap."""
    if cap_bytes <= 0:
        raise ValueError("cap_bytes must be positive")
    last, acc = [], 0
    for i, s in enumerate(specs):
        acc += s.nbytes
        if acc >= cap_bytes:
            last.append(i)
            acc = 0
    if not last or last[-1] != len(specs) - 1:
        last.append(len(specs) - 1)
    return MergePlan.from_boundaries(len(specs), last, f"fixed:{cap_bytes}")


# ---------------------------------------------------------------------------
# Paper Algorithm 1 (faithful).
# ---------------------------------------------------------------------------

def _comm_starts(t_c: list[float], t_b_end: list[float]) -> list[float]:
    """Paper's CALCULATECOMMSTART in backward-order indexing (Eq. 7).

    ``t_b_end[i]`` is the timestamp when tensor i's gradient is ready;
    communication i starts at max(previous comm end, ready time).
    """
    L = len(t_c)
    tau_c = [0.0] * L
    tau_c[0] = t_b_end[0]
    for i in range(1, L):
        tau_c[i] = max(tau_c[i - 1] + t_c[i - 1], t_b_end[i])
    return tau_c


def plan_mgwfbp(specs: Sequence[TensorSpec], model: AllReduceModel) -> MergePlan:
    """The paper's Algorithm 1: optimal merged-gradient assignment.

    Faithful O(L^2) implementation.  Iterates tensors in backward order
    (paper: ``for l = L -> 2``); tensor i becomes a merged-gradient layer iff

        t_b_end[i+1] - tau_c[i] < a                         (paper Eq. 38)

    where ``t_b_end[i+1]`` is when the *next* tensor's gradient is ready and
    ``tau_c[i]`` is when tensor i's communication could start.  After each
    merge the communication start times are recomputed (paper line 13).
    """
    L = len(specs)
    if L == 0:
        return MergePlan((), "mgwfbp")
    model = cost_model.as_linear(model)
    a = model.a
    p = [float(s.nbytes) for s in specs]
    t_c = [model.time(x) for x in p]
    # Gradient-ready timestamps (backward start == 0):
    t_b_end, acc = [], 0.0
    for s in specs:
        acc += s.t_b
        t_b_end.append(acc)

    merged = [False] * L
    tau_c = _comm_starts(t_c, t_b_end)
    for i in range(L - 1):              # paper: l = L..2 (tensor i merges into i+1)
        if t_b_end[i + 1] - tau_c[i] < a:
            merged[i] = True
            # paper MERGE(): zero out this comm, grow the next one.
            p[i + 1] += p[i]
            p[i] = 0.0
            t_c[i] = 0.0
            t_c[i + 1] = model.time(p[i + 1])
            tau_c = _comm_starts(t_c, t_b_end)
    return MergePlan.from_merged_flags(merged, "mgwfbp")


# ---------------------------------------------------------------------------
# Beyond-paper: provably optimal DP and exhaustive search.
# ---------------------------------------------------------------------------

def plan_dp_optimal(specs: Sequence[TensorSpec], model: AllReduceModel) -> MergePlan:
    """O(L^2) dynamic program minimizing the final all-reduce finish time.

    Let ``f[i]`` be the minimum finish time of all communications covering
    tensors ``0..i`` given tensor i closes a bucket.  Buckets are contiguous,
    and a bucket (j+1..i) may start at max(f[j], ready[i]):

        f[i] = min_{j<i} max(f[j], ready[i]) + T(bytes[j+1..i])

    Because every plan's iteration time is ``t_f + max(f[L-1], ready[L-1])``
    and ``f[L-1] >= ready[L-1]`` always, minimizing f[L-1] minimizes the
    iteration time — this gives a certified-optimal reference for Algorithm 1
    (see tests/test_planner.py) and is the planner we ship as default.
    """
    L = len(specs)
    if L == 0:
        return MergePlan((), "dp_optimal")
    model = cost_model.as_linear(model)
    ready, acc = [], 0.0
    for s in specs:
        acc += s.t_b
        ready.append(acc)
    pre = [0] * (L + 1)   # prefix bytes
    for i, s in enumerate(specs):
        pre[i + 1] = pre[i] + s.nbytes

    NEG = -1
    f = [float("inf")] * L
    parent = [NEG] * L
    for i in range(L):
        # bucket = (0..i)
        f[i] = ready[i] + model.time(pre[i + 1])
        parent[i] = NEG
        for j in range(i):
            cand = max(f[j], ready[i]) + model.time(pre[i + 1] - pre[j + 1])
            if cand < f[i] - 1e-15:
                f[i] = cand
                parent[i] = j
    last, i = [], L - 1
    while i != NEG:
        last.append(i)
        i = parent[i]
    return MergePlan.from_boundaries(L, sorted(last), "dp_optimal")


# ---------------------------------------------------------------------------
# Fast path: incremental O(L log L) planner.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpecDelta:
    """A change to a planning problem, consumed by :meth:`Planner.update`.

    Applied in order: ``updates`` (index -> replacement spec), then
    ``truncate`` (keep the first ``truncate`` tensors), then ``append``.
    ``model`` swaps the cost model (elastic resize / online (a, b) refit)
    without touching the specs.
    """

    model: AllReduceModel | None = None
    updates: Mapping[int, TensorSpec] | None = None
    truncate: int | None = None
    append: tuple[TensorSpec, ...] = ()


class Planner:
    """Incremental DP-optimal merge planner.

    Same objective as :func:`plan_dp_optimal` —

        f[i] = min_{j<i}  max(f[j], ready[i]) + T(pre[i+1] - pre[j+1])

    — but evaluated in O(1) amortized per tensor instead of O(L) by
    splitting the candidate set ``j`` on ``f[j] <= ready[i]``:

    * **overlapped** candidates (``f[j] <= ready[i]``): the bucket starts at
      ``ready[i]``, so the best candidate maximizes ``pre[j+1]`` — and since
      prefix bytes are nondecreasing that is simply the *largest* such j.
      Because both ``f`` and ``ready`` are nondecreasing, the split point
      only moves right: a two-pointer suffices.
    * **queued** candidates (``f[j] > ready[i]``): the bucket starts at
      ``f[j]``, so the best candidate minimizes ``g[j] = f[j] - b*pre[j+1]``
      over a window whose ends both move right — a classic monotonic-deque
      sliding minimum.

    The DP frontier (``f``/``parent``/prefix arrays) persists on the
    instance, so :meth:`update` only recomputes the suffix at/after the
    first changed tensor — O(L - k) for a point edit, O(1) amortized for a
    stream of appends, O(L) for a cost-model swap (still a ~L× win over the
    O(L^2) reference planners, which is what makes replanning cheap enough
    for simulator sweeps and contention fixpoints).  ``scratch_plans`` /
    ``incremental_updates`` count how state was (re)built; the benchmark
    smoke guard asserts sweeps never fall back to from-scratch planning.
    """

    strategy = "dp_incremental"

    def __init__(self, specs: Sequence[TensorSpec], model: AllReduceModel,
                 *, recorder=None):
        self.scratch_plans = 0
        self.incremental_updates = 0
        # optional recorder (anything with ``record(EventRecord)``)
        self.recorder = recorder
        self._specs: list[TensorSpec] = list(specs)
        # path models flatten to the (a, b) the DP consumes; a flat model
        # passes through untouched (bit-identical to pre-path behavior)
        self._model = cost_model.as_linear(model)
        self._rebuild()

    # -- public API ------------------------------------------------------

    @property
    def specs(self) -> tuple[TensorSpec, ...]:
        return tuple(self._specs)

    @property
    def model(self) -> AllReduceModel:
        return self._model

    @property
    def num_tensors(self) -> int:
        return len(self._specs)

    def plan(self) -> MergePlan:
        """The current optimal plan (cached; O(#buckets) to materialize)."""
        if self._plan is None:
            L = len(self._specs)
            if L == 0:
                self._plan = MergePlan((), self.strategy)
            else:
                last, i = [], L - 1
                while i >= 0:
                    last.append(i)
                    i = self._parent[i]
                self._plan = MergePlan.from_boundaries(L, sorted(last),
                                                       self.strategy)
        return self._plan

    @property
    def finish_time(self) -> float:
        """Optimal final communication finish time f[L-1] (0 if L == 0)."""
        return self._f[-1] if self._f else 0.0

    def update(self, delta: SpecDelta) -> MergePlan:
        """Apply a delta and replan, reusing the unchanged DP prefix."""
        # validate the whole delta before mutating anything — a partial
        # application would leave specs and DP state silently inconsistent
        if delta.updates:
            bad = [i for i in delta.updates if not 0 <= i < len(self._specs)]
            if bad:
                raise IndexError(f"update indices {bad} out of range "
                                 f"0..{len(self._specs) - 1}")
        if delta.truncate is not None and \
                not 0 <= delta.truncate <= len(self._specs):
            raise IndexError(f"truncate {delta.truncate} out of range")
        self.incremental_updates += 1
        dirty = len(self._specs)            # first index whose DP is stale
        if delta.updates:
            for idx, spec in sorted(delta.updates.items()):
                if self._specs[idx] != spec:
                    self._specs[idx] = spec
                    dirty = min(dirty, idx)
        if delta.truncate is not None and delta.truncate < len(self._specs):
            del self._specs[delta.truncate:]
            dirty = min(dirty, delta.truncate)
        if delta.append:
            dirty = min(dirty, len(self._specs))
            self._specs.extend(delta.append)
        if delta.model is not None:
            model = cost_model.as_linear(delta.model)
            if (model.a != self._model.a or
                    model.b != self._model.b):
                dirty = 0                   # every edge cost changed
            self._model = model
        self._refresh(dirty)
        REGISTRY.counter(
            "planner_incremental_updates_total",
            "Planner.update calls (suffix-reuse replans)").inc()
        plan = self.plan()
        if self.recorder is not None:
            self.recorder.record(EventRecord(
                kind="planner_update", time=float(self.incremental_updates),
                source="planner",
                args={"plan": plan_fingerprint(plan),
                      "num_buckets": plan.num_buckets,
                      "dirty_from": dirty,
                      "model_a": self._model.a, "model_b": self._model.b}))
        return plan

    def replan(self, model: AllReduceModel) -> MergePlan:
        """Convenience: elastic resize / (a, b) refit -> new plan."""
        return self.update(SpecDelta(model=model))

    def append(self, *specs: TensorSpec) -> MergePlan:
        """Convenience: streaming profile ingestion."""
        return self.update(SpecDelta(append=tuple(specs)))

    # -- internals -------------------------------------------------------

    def _rebuild(self) -> None:
        """Full state construction from the spec list (counted)."""
        self.scratch_plans += 1
        REGISTRY.counter(
            "planner_scratch_plans_total",
            "Planner from-scratch DP rebuilds").inc()
        self._ready: list[float] = []
        self._pre: list[float] = [0.0]      # prefix bytes, extended index m
        acc_t = 0.0
        for s in self._specs:
            acc_t += s.t_b
            self._ready.append(acc_t)
            self._pre.append(self._pre[-1] + s.nbytes)
        self._F: list[float] = [0.0]        # F[m] = f[m-1], F[0] = 0
        self._g: list[float] = [0.0]        # g[m] = F[m] - b*pre[m]
        self._f: list[float] = []
        self._parent: list[int] = []
        self._dq: collections.deque[int] = collections.deque()
        self._p = 0
        self._plan: MergePlan | None = None
        self._run_dp(0)

    def _refresh(self, dirty: int) -> None:
        """Recompute prefix arrays and DP from ``dirty`` onwards."""
        L = len(self._specs)
        appended_only = dirty >= len(self._ready)
        del self._ready[dirty:]
        del self._pre[dirty + 1:]
        acc_t = self._ready[dirty - 1] if dirty else 0.0
        for s in self._specs[dirty:]:
            acc_t += s.t_b
            self._ready.append(acc_t)
            self._pre.append(self._pre[-1] + s.nbytes)
        del self._f[dirty:]
        del self._parent[dirty:]
        del self._F[dirty + 1:]
        del self._g[dirty + 1:]
        self._plan = None
        if not appended_only:
            # rebuild the frontier (two-pointer + deque) at position dirty
            if dirty == 0:
                self._p, self._dq = 0, collections.deque()
            else:
                # dirty == L after a bare truncate; ready[L-1] is a valid
                # lower bound for the next tensor's ready time (the pointer
                # only ever needs to start at or below its true position).
                r = self._ready[dirty] if dirty < L else self._ready[-1]
                self._p = bisect.bisect_right(self._F, r, 0, dirty + 1) - 1
                self._dq = collections.deque()
                g = self._g
                for m in range(self._p + 1, dirty):
                    while self._dq and g[self._dq[-1]] > g[m]:
                        self._dq.pop()
                    self._dq.append(m)
        self._run_dp(dirty)

    def _run_dp(self, start: int) -> None:
        """The vectorized-recurrence DP loop over tensors [start, L)."""
        L = len(self._specs)
        if start >= L:
            return
        a, b = self._model.a, self._model.b
        ready, pre = self._ready, self._pre
        F, g, f, parent = self._F, self._g, self._f, self._parent
        dq, p = self._dq, self._p
        for i in range(start, L):
            # new candidate m = i (bucket opens after tensor i-1)
            gi = g[i]
            while dq and g[dq[-1]] > gi:
                dq.pop()
            dq.append(i)
            r = ready[i]
            # two-pointer split: F[m] <= ready[i]  <=>  m <= p
            while p < i and F[p + 1] <= r:
                p += 1
            while dq and dq[0] <= p:
                dq.popleft()
            pre_i1 = pre[i + 1]
            # overlapped side: start at ready[i], maximize pre[m] -> m = p
            d = pre_i1 - pre[p]
            best = r + (a + b * d if d > 0 else 0.0)
            best_m = p
            # queued side: start at F[m], minimize g[m] over the window
            if dq:
                m = dq[0]
                d = pre_i1 - pre[m]
                cand = F[m] + (a + b * d if d > 0 else 0.0)
                if cand < best:
                    best, best_m = cand, m
            # zero-byte tail: an empty trailing bucket costs exactly 0, not
            # a — the g-ranking above overcharges it, so handle explicitly.
            if pre[i] == pre_i1:
                m = bisect.bisect_left(pre, pre_i1, 0, i + 1)
                cand = F[m] if F[m] > r else r
                if cand < best:
                    best, best_m = cand, m
            f.append(best)
            parent.append(best_m - 1)
            F.append(best)
            g.append(best - b * pre_i1)
        self._p = p


def plan_incremental(specs: Sequence[TensorSpec],
                     model: AllReduceModel) -> MergePlan:
    """One-shot use of the fast planner (same optimum as plan_dp_optimal)."""
    return Planner(specs, model).plan()


# ---------------------------------------------------------------------------
# Not yet ported.
# ---------------------------------------------------------------------------

def plan_contention_aware(*args, **kwargs):
    """The plan -> simulate -> refit fixpoint and the co-planner it runs on
    need the cluster simulator, which the port does not have yet."""
    raise NotImplementedError(
        "plan_contention_aware / the co-planner are not ported yet "
        "(ROADMAP queue 1, item 13)")


# ---------------------------------------------------------------------------
# Dispatch + elastic re-planning.
# ---------------------------------------------------------------------------

def make_plan(strategy: str, specs: Sequence[TensorSpec],
              model: AllReduceModel | None = None) -> MergePlan:
    """Build a plan from a strategy string.

    ``wfbp`` | ``single`` | ``mgwfbp`` | ``dp_optimal`` | ``dp_incremental``
    | ``fixed:<bytes>``.  ``dp_batched`` (the fleet backend's batched DP)
    is not ported yet and raises.
    """
    if strategy == "wfbp":
        return plan_wfbp(specs)
    if strategy == "single":
        return plan_single(specs)
    if strategy.startswith("fixed:"):
        return plan_fixed_size(specs, int(strategy.split(":", 1)[1]))
    if model is None:
        raise ValueError(f"strategy {strategy!r} needs a cost model")
    if strategy == "mgwfbp":
        return plan_mgwfbp(specs, model)
    if strategy == "dp_optimal":
        return plan_dp_optimal(specs, model)
    if strategy == "dp_incremental":
        return plan_incremental(specs, model)
    if strategy == "dp_batched":
        raise NotImplementedError(
            "dp_batched needs the fleet backend, not ported yet "
            "(ROADMAP queue 1, item 13)")
    raise ValueError(f"unknown merge strategy {strategy!r}")

