"""Online refit + replan: the measure -> plan -> execute loop on the live step.

Port of ``repro.train.replan``.  MG-WFBP's pipeline is measure -> plan ->
execute (paper §5.1, Alg. 2), and the paper measures once, before
training.  This module keeps the loop closed during training:

* :func:`measure_comm_model` — time real ``dist.all_reduce`` calls on the
  data-parallel group (NCCL on the card, gloo on the CPU) at several
  message sizes and least-squares fit (a, b) (``cost_model.fit``): the
  measured counterpart of ``cost_model.production_comm_model``.
* :class:`ReplanController` — host code identical to the reference's: it
  consumes the :class:`~repro_torch.obs.recorder.IterationRecord` stream
  of ``train.step.instrument_step`` (its ``on_record`` hook), refits the
  effective comm model from the observed non-overlapped communication,
  drives the incremental :class:`~repro_torch.core.planner.Planner`
  (which records ``planner_update`` events) and, when the new plan's
  predicted win beats a hysteresis, rebuilds the step with
  ``build_train_step(plan_override=...)`` between iterations.
* :func:`closed_loop` — the whole pipeline: build the step from the
  measured costs, wrap it with instrumentation, and attach a controller
  whose rebuild callback re-derives the step.  The rebuilt step rebinds
  the state on its first call (the old plan's hooks detached, new kernel
  member tables over the same gradient storages), so a swap moves no
  parameter, gradient or optimizer storage.

Each rank of a data-parallel group runs its own controller.  The ranks
must take the same decisions, or they would issue different buckets:
:func:`measure_comm_model` and :func:`closed_loop` therefore agree on
every time they feed the planner (the largest over the ranks, the time
of the slowest one, which is what a synchronous step takes).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import cost_model
from repro_torch.core import planner as planner_mod
from repro_torch.core.cost_model import AllReduceModel
from repro_torch.core.planner import MergePlan, SpecDelta, TensorSpec
from repro_torch.core.simulator import simulate
from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.recorder import IterationRecord
from repro_torch.train.step import build_train_step, instrument_step

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Measured communication model.
# ---------------------------------------------------------------------------

def _slowest(values: list[float], group, device) -> list[float]:
    """Every rank's ``values`` replaced by their elementwise maximum over
    ``group``."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def measure_comm_model(group, dp_axes: Sequence[str],
                       sizes_bytes: Sequence[int] = (1 << 16, 1 << 19,
                                                     1 << 22),
                       *, n_warmup: int = 1, n_iters: int = 5,
                       name: str = "measured",
                       device="cuda") -> AllReduceModel:
    """Fit (a, b) from real timed all-reduces of float32 buffers on
    ``group``.

    Per message size: one untimed first call and ``n_warmup`` more, then
    a wall clock around ``n_iters`` calls, each waited for (a device
    synchronize on the card).  With several ranks each size's time is the
    slowest rank's, so every rank fits the same model.  With no data axes
    nothing is reduced and an identity is timed: the fit then holds
    dispatch cost only, which is the right effective model for that
    degenerate layout.  With one size the model is latency only.

    ``device`` holds the buffers: the card (the default) for an NCCL
    group, the CPU for a gloo group.
    """
    device = torch.device(device)
    axes = tuple(dp_axes)
    if axes and dist.get_backend(group) == "nccl" and device.type != "cuda":
        raise ValueError("an NCCL group all-reduces buffers on the card; "
                         f"got device {device}")
    wait = device.type == "cuda"
    samples_n: list[float] = []
    samples_t: list[float] = []
    for nbytes in sizes_bytes:
        n_elems = max(1, int(nbytes) // 4)
        x = torch.zeros(n_elems, dtype=torch.float32, device=device)

        def call(x=x):
            if axes:
                dist.all_reduce(x, group=group)
            else:
                x.add(0.0)
            if wait:
                torch.cuda.synchronize(device)

        for _ in range(1 + n_warmup):
            call()
        t0 = time.perf_counter()
        for _ in range(n_iters):
            call()
        samples_n.append(float(n_elems * 4))
        samples_t.append((time.perf_counter() - t0) / n_iters)
    if axes and dist.get_world_size(group) > 1:
        samples_t = _slowest(samples_t, group, device)
    if len(set(samples_n)) >= 2:
        return cost_model.fit(samples_n, samples_t, name)
    # single size: degenerate fit -> all latency, zero slope
    return AllReduceModel(max(samples_t[0], _EPS), 0.0, name)


# ---------------------------------------------------------------------------
# The controller.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplanDecision:
    """One refit round: what the controller saw and what it did."""

    iteration: int
    observed_t_iter: float       # window-median wall iteration time
    stretch: float               # observed / predicted non-overlapped comm
    model: AllReduceModel        # effective model AFTER this refit
    old_plan: MergePlan
    new_plan: MergePlan
    predicted_old: float         # t_iter of old plan under the new model
    predicted_new: float         # t_iter of new plan under the new model
    swapped: bool

    @property
    def predicted_win(self) -> float:
        """Relative improvement the swap was judged on."""
        if self.predicted_old <= 0:
            return 0.0
        return (self.predicted_old - self.predicted_new) / self.predicted_old


class ReplanController:
    """Consume live IterationRecords; refit, replan, and swap the step.

    Policy knobs:

    * ``warmup``      — records ignored for refitting;
    * ``interval``    — records per refit window (median over the window
                        rejects stragglers);
    * ``damping``     — weight of the fresh fit against the previous
                        effective model (``cost_model.blend``);
    * ``hysteresis``  — minimum predicted relative win before a swap;
    * ``min_stretch`` / ``max_stretch`` — clamp on the per-round refit
                        ratio so one pathological window cannot catapult
                        the model.

    The controller plugs into ``instrument_step(..., on_record=ctl.observe)``.
    ``rebuild`` is called with the winning :class:`MergePlan` and must
    return the new (instrumented) step callable; it is exposed as
    :attr:`step_fn`, which the driving loop reads each iteration (see
    :func:`closed_loop`).  Every record also feeds a
    :class:`DriftMonitor` comparing the current plan's closed-form
    prediction against the wall time.
    """

    def __init__(self, specs: Sequence[TensorSpec], plan: MergePlan,
                 model: AllReduceModel, *,
                 t_f: float = 0.0,
                 rebuild: Callable[[MergePlan], Callable] | None = None,
                 recorder=None,
                 warmup: int = 2, interval: int = 4,
                 damping: float = 0.5, hysteresis: float = 0.05,
                 drift_threshold: float = 0.15,
                 min_stretch: float = 0.1, max_stretch: float = 10.0):
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        if not 0.0 <= damping <= 1.0:
            raise ValueError(f"damping must be in [0, 1], got {damping}")
        self.specs = list(specs)
        self.plan = plan
        self.model = cost_model.as_linear(model)
        self.t_f = float(t_f)
        self.rebuild = rebuild
        self.recorder = recorder
        self.warmup = int(warmup)
        self.interval = int(interval)
        self.damping = float(damping)
        self.hysteresis = float(hysteresis)
        self.min_stretch = float(min_stretch)
        self.max_stretch = float(max_stretch)
        self.planner = planner_mod.Planner(self.specs, self.model,
                                           recorder=recorder)
        self.monitor = DriftMonitor(threshold=drift_threshold,
                                    warmup=max(1, warmup),
                                    recorder=recorder,
                                    source="train", job="replan")
        self.step_fn: Callable | None = None   # set by rebuild / closed_loop
        self.decisions: list[ReplanDecision] = []
        self._window: list[float] = []
        self._n = 0

    # -- ingestion -------------------------------------------------------

    def observe(self, rec: IterationRecord) -> ReplanDecision | None:
        """Feed one live record; returns the decision if a refit ran."""
        observed = rec.end - rec.start
        self._n += 1
        pred = simulate(self.specs, self.plan, self.model, self.t_f)
        self.monitor.observe(rec.iteration, pred.t_iter, observed)
        if self._n <= self.warmup:
            return None
        self._window.append(observed)
        if len(self._window) < self.interval:
            return None
        return self._refit(rec.iteration)

    def update_backward_times(self, tb_table: dict[str, float]) -> MergePlan:
        """Point-refit per-tensor backward times (``path -> seconds``),
        e.g. from a fresh ``profiler.measure_loss_profile`` pass, through
        ``Planner.update`` (only the suffix from the first changed tensor
        is recomputed)."""
        updates = {}
        for i, s in enumerate(self.specs):
            t_b = tb_table.get(s.name)
            if t_b is not None and t_b > 0 and t_b != s.t_b:
                updates[i] = dataclasses.replace(s, t_b=float(t_b))
        if not updates:
            return self.planner.plan()
        for i, s in updates.items():
            self.specs[i] = s
        return self.planner.update(SpecDelta(updates=updates))

    # -- the refit round -------------------------------------------------

    def _refit(self, iteration: int) -> ReplanDecision:
        window = sorted(self._window)
        self._window.clear()
        observed = window[len(window) // 2]              # median
        pred = simulate(self.specs, self.plan, self.model, self.t_f)
        # Observed non-overlapped communication: everything the wall
        # clock spent beyond forward + backward compute.  Its stretch
        # against the prediction rescales (a, b) uniformly (host-side
        # records carry per-bucket estimates, not measurements).
        obs_t_c_no = max(observed - (self.t_f + pred.t_b_total), 0.0)
        if pred.t_c_no > _EPS:
            stretch = obs_t_c_no / pred.t_c_no
        else:
            stretch = 1.0
        stretch = min(max(stretch, self.min_stretch), self.max_stretch)
        new_model = cost_model.blend(self.model,
                                     self.model.scaled(stretch),
                                     self.damping)
        new_plan = self.planner.replan(new_model)   # planner_update event
        self.model = new_model
        old_plan = self.plan
        t_old = simulate(self.specs, old_plan, new_model, self.t_f).t_iter
        t_new = simulate(self.specs, new_plan, new_model, self.t_f).t_iter
        win = (t_old - t_new) / t_old if t_old > 0 else 0.0
        swapped = False
        if new_plan.buckets != old_plan.buckets and win > self.hysteresis:
            if self.rebuild is not None:
                self.step_fn = self.rebuild(new_plan)
            self.plan = new_plan
            swapped = True
            self.monitor.reset()
        decision = ReplanDecision(
            iteration=iteration, observed_t_iter=observed, stretch=stretch,
            model=new_model, old_plan=old_plan,
            new_plan=new_plan, predicted_old=t_old, predicted_new=t_new,
            swapped=swapped)
        self.decisions.append(decision)
        return decision

    @property
    def swaps(self) -> list[ReplanDecision]:
        return [d for d in self.decisions if d.swapped]


# ---------------------------------------------------------------------------
# End-to-end assembly: measure -> plan -> execute -> refit -> replan.
# ---------------------------------------------------------------------------

def closed_loop(model, run, group=None, *,
                strategy: str | None = None,
                tb_table: dict | None = None,
                comm_model: AllReduceModel | None = None,
                t_f: float = 0.0,
                recorder=None,
                instrument: bool = True,
                device="cuda",
                **controller_kwargs):
    """Build a measured-cost train step with a live replan loop attached.

    Returns ``(controller, init_fn, art)``.  ``controller.step_fn`` is the
    instrumented step to drive; after each call the controller may have
    swapped in a rebuilt step, so read the attribute fresh every
    iteration:

        ctl, init_fn, art = closed_loop(model, run, group, ...)
        state = init_fn(torch.Generator(device).manual_seed(0))
        for batch in batches:
            state, metrics = ctl.step_fn(state, batch)

    ``comm_model`` / ``tb_table`` / ``t_f`` are the measured costs (from
    :func:`measure_comm_model` and ``profiler.measure_loss_profile``);
    every rank must pass the same ones.  Omitted, the step plans from the
    analytic priors.

    ZeRO-1 raises ``NotImplementedError``: its flat moments are laid out
    per bucket shard of one plan, and neither the reference nor the port
    re-lays them out.  ``build_train_step`` with measured costs runs
    ZeRO-1 from a measured plan, without a swap.
    """
    par = run.parallel
    if par.zero and par.dp_axes:
        raise NotImplementedError(
            f"closed_loop swaps plans under ZeRO-0 only: ZeRO-{par.zero}'s "
            f"optimizer state is laid out per bucket shard of one plan")
    step_fn, init_fn, art = build_train_step(
        model, run, group, strategy=strategy, tb_table=tb_table,
        comm_model=comm_model, device=device)

    ctl = ReplanController(art.specs, art.plan, art.comm_model,
                           t_f=t_f, recorder=recorder,
                           **controller_kwargs)

    def observe(rec: IterationRecord):
        if art.world > 1:
            t = _slowest([rec.end - rec.start], group, art.device)[0]
            rec = dataclasses.replace(rec, end=rec.start + t)
        return ctl.observe(rec)

    def _wrap(fn, artifacts):
        if not instrument:
            return fn
        return instrument_step(fn, artifacts, t_f=t_f, recorder=recorder,
                               on_record=observe)

    def rebuild(plan: MergePlan):
        new_fn, _, new_art = build_train_step(
            model, run, group, strategy=strategy, tb_table=tb_table,
            comm_model=ctl.model, device=device, plan_override=plan)
        art.plan = new_art.plan
        art.comm_model = new_art.comm_model
        return _wrap(new_fn, new_art)

    ctl.rebuild = rebuild
    ctl.step_fn = _wrap(step_fn, art)
    return ctl, init_fn, art
