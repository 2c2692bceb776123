"""Data-parallel train step with MG-WFBP-scheduled gradient communication.

Port of ``repro.train.step`` (ZeRO-0 and ZeRO-1).  Construction
(:func:`build_train_step`) happens once:

  1. Build the parameter tree on the ``meta`` device and make the planner's
     :class:`TensorSpec`s from the analytic per-tensor backward-time model
     (core/profiler.py), or from a measured ``tb_table``.
  2. Ask the planner for the merge plan (``mgwfbp`` / ``wfbp`` / ``single``
     / ``fixed:N`` / ``dp_optimal``) against the all-reduce cost model of
     the data-parallel world, or against ``comm_model`` when given.
  3. Return the step.  Each step runs backward with a post-accumulate-grad
     hook on every parameter; the hooks issue the planned buckets' packed
     all-reduces in plan order while backward is still running
     (:class:`repro_torch.core.comm.BucketedAllReduce`).  After backward
     the step waits on every bucket, unpacks into the gradients in place,
     clips, and applies the optimizer.

ZeRO-1 (``run.parallel.zero == 1``, qwen2's own setting) runs the same
hooks with a reduce-scatter in place of the all-reduce, so each rank keeps
one shard of every reduced bucket.  The gradient norm is taken from the
shards, as the reference takes it.  Then, bucket by bucket, the
parameters are packed (K1), ``Optimizer.flat_update`` runs on this rank's
shard with the bucket's weight-decay mask and the rank's flat moments,
and the updated shards are all-gathered and unpacked (K2) into the
parameters in place.  Because the norm is a sum over the plan's buckets,
two plans agree bit for bit only without clipping (``grad_clip`` 0); the
update itself is elementwise.

The state is updated in place.  Each rank passes its own shard of the
batch (``global_batch / world`` sequences).  ZeRO-3, expert parallelism
and hierarchical collectives are not ported yet (ROADMAP queue 1, item 5).

A step built for another plan (``plan_override``, the replan loop's swap)
rebinds the state it is given on its first call: it detaches the old
plan's hooks and builds its own :class:`BucketedAllReduce`, with new
kernel member tables, over the same gradient storages.  Nothing of the
state moves.  Under ZeRO-1 the flat moments are laid out per bucket
shard, so a state cannot change plans there (the reference has no
re-layout either).

:func:`instrument_step` wraps a step with host-side flight recording: a
wall clock around the step, which ends in a device synchronize on the
card.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.configs.base import RunConfig
from repro_torch.core import bucketer, comm, cost_model, planner, profiler
from repro_torch.core.simulator import simulate
from repro_torch.models.transformer import LM
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.recorder import (BucketRecord, IterationRecord,
                                      plan_fingerprint)
from repro_torch.optim import clip as oclip
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.train_state import TrainState
from repro_torch.utils import tree


@dataclasses.dataclass
class StepArtifacts:
    """Everything the launcher needs besides the step function itself."""
    plan: planner.MergePlan
    specs: list
    comm_model: cost_model.AllReduceModel
    world: int
    n_micro: int
    device: torch.device


# ---------------------------------------------------------------------------
# Planning.
# ---------------------------------------------------------------------------

def build_plan(params_shape, run: RunConfig, mesh_shape, mesh_axes,
               strategy: str | None = None,
               tb_table: dict | None = None,
               comm_model=None):
    """Merge plan + tensor specs + cost model for this run.

    ``params_shape`` is the parameter tree (tensors on any device, ``meta``
    included); ``mesh_shape``/``mesh_axes`` describe the data-parallel
    layout as the reference's mesh does.  ``tb_table``: measured
    per-tensor backward times ``{path: seconds}``, with the analytic model
    as the fallback.  ``comm_model``: override the layout-derived
    all-reduce model.  Returns ``(plan, ep_plan, specs, model)`` as the
    reference does; ``ep_plan`` is None until expert parallelism and the
    ZeRO-3 exclusions are ported (ROADMAP queue 1, items 9 and 10).
    """
    par = run.parallel
    dims = dict(zip(mesh_axes, mesh_shape))
    dp_total = 1
    for a in par.dp_axes:
        dp_total *= dims.get(a, 1)
    local_batch = max(run.shape.global_batch // max(dp_total, 1), 1)
    micro = min(run.microbatch or local_batch, local_batch)
    t_b = profiler.analytic_tb(micro * run.shape.seq_len)
    if tb_table:
        t_b = profiler.measured_tb(tb_table, t_b)
    specs = [s for s in bucketer.tensor_specs(params_shape, t_b) if s.nbytes]
    model = comm_model if comm_model is not None else \
        cost_model.production_comm_model(mesh_shape, mesh_axes, par.dp_axes)
    plan = planner.make_plan(strategy or par.comm_strategy, specs, model)
    return plan, None, specs, model


def _decay_mask_shards(params_shape, plan, opt, use_kernel: bool,
                       world: int, rank: int, device) -> list[torch.Tensor]:
    """Per bucket, this rank's shard of the packed weight-decay mask: True
    over the elements of a leaf that ``opt.weight_decay_mask`` decays,
    False on the other leaves, on slot tails and on shard padding (the
    reference's ``decay_masks``, kept as bool to save 3 bytes an
    element)."""
    metas = bucketer.leaf_metadata(params_shape)
    out = []
    for bucket in plan.buckets:
        bmetas = [metas[i] for i in bucket]
        size = comm.bucket_shard_size(
            bucketer.packed_elems(bmetas, aligned=use_kernel), world)
        mask = torch.zeros(size * world, dtype=torch.bool, device=device)
        off = 0
        for m in bmetas:
            if opt.weight_decay_mask(m.path):
                mask[off:off + m.size] = True
            off += bucketer.slot_elems(m.size, aligned=use_kernel)
        out.append(mask[rank * size:(rank + 1) * size].clone())
    return out


# ---------------------------------------------------------------------------
# Step builder.
# ---------------------------------------------------------------------------

def _check_supported(run: RunConfig) -> None:
    par = run.parallel
    if par.zero not in (0, 1):
        raise NotImplementedError(f"ZeRO-{par.zero} is not ported yet "
                                  f"(ROADMAP queue 1, item 5); use zero=0 "
                                  f"or 1")
    if par.ep_axis:
        raise NotImplementedError("expert parallelism is not ported yet")
    if len(par.dp_axes) > 1:
        raise NotImplementedError("one data-parallel axis only: "
                                  "hierarchical collectives are not ported")


def build_train_step(model: LM, run: RunConfig, group=None,
                     strategy: str | None = None,
                     tb_table: dict | None = None, comm_model=None,
                     device="cuda",
                     plan_override: planner.MergePlan | None = None):
    """Returns ``(step_fn, init_fn, StepArtifacts)``.

    ``group`` is the data-parallel process group (default: the default
    group); it must be initialized unless ``run.parallel.dp_axes`` is
    empty, in which case nothing is reduced.  ``tb_table`` / ``comm_model``
    thread measured or assumed costs into the plan (see
    :func:`build_plan`).  ``plan_override`` installs a given merge plan
    over the same tensor specs, bypassing the strategy (the replan loop's
    swap; bucketing changes step timing, never numerics).

    ``init_fn(generator=None, params=None)`` returns a :class:`TrainState`
    from fresh parameters drawn from ``generator`` or from a given
    parameter tree (moved to ``device``).  ``step_fn(state, batch)`` runs
    one step in place and returns ``(state, metrics)`` with 0-d tensor
    metrics.
    """
    _check_supported(run)
    par = run.parallel
    device = torch.device(device)
    reduce_grads = bool(par.dp_axes)
    world = dist.get_world_size(group) if reduce_grads else 1
    rank = dist.get_rank(group) if reduce_grads else 0
    # ZeRO-1 shards over the data axis: without one it is ZeRO-0, as in the
    # reference
    zero = par.zero if reduce_grads else 0
    mesh_axes = tuple(par.dp_axes) or ("data",)
    mesh_shape = (world,) + (1,) * (len(mesh_axes) - 1)

    opt = make_optimizer(run.optimizer, weight_decay=run.weight_decay,
                         state_dtype=run.optimizer_state_dtype,
                         b1=run.adam_b1, b2=run.adam_b2, eps=run.adam_eps,
                         momentum=run.sgd_momentum)
    lr_fn = warmup_cosine(run.learning_rate, run.warmup_steps,
                          run.total_steps)
    # paper §5.3 contiguous-buffer execution through the bucket_pack kernels
    use_kernel = bool(par.pack_kernel)

    params_shape = model.init(None, device="meta")
    plan, _, specs, cmodel = build_plan(params_shape, run, mesh_shape,
                                        mesh_axes, strategy,
                                        tb_table=tb_table,
                                        comm_model=comm_model)
    if plan_override is not None:
        if plan_override.num_tensors != len(specs):
            raise ValueError(
                f"plan_override covers {plan_override.num_tensors} tensors "
                f"but the step has {len(specs)}")
        plan = plan_override

    local_batch = max(run.shape.global_batch // max(world, 1), 1)
    micro = min(run.microbatch or local_batch, local_batch)
    n_micro = max(local_batch // micro, 1)

    # this rank's shard of each bucket's weight-decay mask (ZeRO-1 only)
    decay_masks = (_decay_mask_shards(params_shape, plan, opt, use_kernel,
                                      world, rank, device)
                   if zero == 1 else None)

    # ------------------------------------------------------------------

    def bind(params, targets) -> comm.BucketedAllReduce:
        """This plan's hook-driven reduction of ``targets``, hooked on
        ``params``."""
        sync = comm.BucketedAllReduce(
            targets, plan, group, mean=True,
            wire_dtype=par.wire_dtype or None, use_kernel=use_kernel,
            collective="reduce_scatter" if zero == 1 else "all_reduce")
        acc_by_index = [t for _, t in
                        bucketer.leaves_in_backward_order(targets)]

        def last_micro(i, p):
            acc_by_index[i].add_(p.grad).div_(n_micro)

        sync.attach(params, None if n_micro == 1 else last_micro)
        return sync

    def rebind(state: TrainState) -> None:
        """Swap ``state`` over to this step's plan, in place."""
        if zero == 1:
            raise NotImplementedError(
                "a ZeRO-1 state cannot change plans: its flat moments are "
                "laid out per bucket shard of the plan it was built for")
        state.grad_sync.detach()
        state.grad_sync = bind(state.params, state.grads)

    def init_fn(generator: torch.Generator | None = None, params=None):
        if params is None:
            params = model.init(generator, device=device)
        else:
            params = tree.tree_map(lambda t: t.detach().to(device).clone(),
                                   params)
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            # kept allocated and zeroed in place each step: the packed
            # buckets' member tables point at these storages
            p.grad = torch.zeros_like(p)
        # microbatching accumulates in float32, as the reference does, and
        # those accumulators are what the buckets carry
        targets = (tree.tree_map(lambda p: p.grad, params) if n_micro == 1
                   else tree.tree_map(lambda p: torch.zeros_like(
                       p, dtype=torch.float32), params))
        sync = bind(params, targets) if reduce_grads else None
        gather = None
        if zero == 1:
            # flat moments per bucket shard, as the reference's init_state
            gather = comm.BucketedAllGather(params, plan, group,
                                            use_kernel=use_kernel)
            opt_state = [opt.init_leaf(torch.zeros(n, dtype=torch.float32,
                                                   device=device))
                         for n in gather.shard_sizes]
        else:
            opt_state = opt.init(params)
        return TrainState.create(params, opt_state, targets, sync, gather)

    def accumulate(params, p_leaves, g_leaves, sync, batch):
        """Microbatches accumulate in float32 into ``g_leaves`` and are
        divided by ``n_micro``; with a sync, the last microbatch's hooks
        do its add-and-divide and issue the buckets."""
        loss_sum = None
        for i in range(n_micro):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            last = i == n_micro - 1
            if last and sync is not None:
                sync.start()
            l, metrics = model.loss(params, mb)
            l.backward()
            loss_sum = l.detach() if loss_sum is None else \
                loss_sum + l.detach()
            with torch.no_grad():
                if i == 0:
                    torch._foreach_copy_(g_leaves, [p.grad for p in p_leaves])
                elif not last or sync is None:
                    torch._foreach_add_(g_leaves, [p.grad for p in p_leaves])
                if not last:
                    torch._foreach_zero_([p.grad for p in p_leaves])
                elif sync is None:
                    torch._foreach_div_(g_leaves, float(n_micro))
        return loss_sum / n_micro, metrics

    def update_zero1(state: TrainState, shards, lr: float) -> torch.Tensor:
        """The reference's ``step_zero1`` after its reduce-scatter: the
        norm from the shards, then per bucket K1 of the parameters, the
        flat update of this rank's shard, the all-gather and K2."""
        with record_function("step/clip"):
            norms = torch._foreach_norm(shards, 2, dtype=torch.float32)
            sq = torch.stack(norms).square().sum()
            if world > 1:
                dist.all_reduce(sq, group=group)
            gnorm = sq.sqrt()
            scale = (torch.clamp(run.grad_clip / torch.clamp(gnorm, min=1e-12),
                                 max=1.0) if run.grad_clip > 0 else None)
        gather = state.param_sync
        with record_function("step/optimizer"), torch.no_grad():
            for k, shard in enumerate(shards):
                buf, pshard = gather.pack_shard(k)
                g = shard.float() if scale is None else shard.float() * scale
                opt.flat_update(g, pshard, state.opt_state[k], state.step,
                                lr, decay_masks[k])
                gather.gather(k, buf, pshard)
        return gnorm

    def step_fn(state: TrainState, batch):
        params = state.params
        p_leaves = tree.leaves(params)
        g_leaves = tree.leaves(state.grads)
        if state.grad_sync is not None and \
                state.grad_sync.plan.buckets != plan.buckets:
            rebind(state)
        sync = state.grad_sync
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        with torch.no_grad():
            torch._foreach_zero_([p.grad for p in p_leaves])
        if sync is not None:
            sync.check(state.grads)
        with record_function("step/forward_backward"):
            if n_micro == 1:
                if sync is not None:
                    sync.start()
                loss, metrics = model.loss(params, batch)
                loss.backward()
                loss = loss.detach()
            else:
                loss, metrics = accumulate(params, p_leaves, g_leaves, sync,
                                           batch)
        shards = None
        if sync is not None:
            with record_function("step/finish_buckets"):
                shards = sync.finish()
        lr = lr_fn(state.step)
        if zero == 1:
            gnorm = update_zero1(state, shards, lr)
        else:
            grads = state.grads
            with record_function("step/clip"):
                gnorm = oclip.global_norm(grads)
                oclip.clip_by_global_norm(grads, run.grad_clip, gnorm)
            with record_function("step/optimizer"):
                opt.update(grads, params, state.opt_state, state.step, lr)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss, grad_norm=gnorm,
                       lr=torch.tensor(lr, dtype=torch.float32))
        if reduce_grads and world > 1:
            names = sorted(metrics)
            vals = torch.stack([metrics[k].to(device).float()
                                for k in names])
            dist.all_reduce(vals, group=group)
            metrics = dict(zip(names, vals / world))
        return state, metrics

    art = StepArtifacts(plan=plan, specs=specs, comm_model=cmodel,
                        world=world, n_micro=n_micro, device=device)
    return step_fn, init_fn, art


# ---------------------------------------------------------------------------
# Host-side observability: the measurement half of the measure -> plan loop.
# ---------------------------------------------------------------------------

def instrument_step(step_fn, art: StepArtifacts, *, job: str = "train",
                    t_f: float = 0.0, recorder=None, source: str = "train",
                    clock=None, sync: bool = True, on_record=None):
    """Wrap a step function with host-side flight recording.

    A wall clock is read before the step and after it; on the card the
    step is first waited for with ``torch.cuda.synchronize``.  Per-bucket
    communication windows are not read on the host, so each record
    carries the closed-form per-bucket estimate (``core.simulator.simulate``
    over the step's own plan, specs and comm model) rescaled to the
    measured wall time and flagged ``estimated_buckets`` in ``args``.
    Every step also lands in the ``train_step_seconds`` histogram.

    ``clock`` injects a time source (deterministic tests); ``sync=False``
    skips the device synchronize (callers that already synchronize).
    ``on_record`` receives each :class:`IterationRecord` after it is
    (optionally) recorded: the hook a
    :class:`repro_torch.train.replan.ReplanController` consumes.
    """
    est = simulate(art.specs, art.plan, art.comm_model, t_f)
    fingerprint = plan_fingerprint(art.plan)
    now = clock if clock is not None else time.perf_counter
    wait = sync and art.device.type == "cuda"
    hist = REGISTRY.histogram("train_step_seconds",
                              "real train-step wall time")
    step_idx = 0

    def wrapped(state, batch):
        nonlocal step_idx
        t0 = now()
        out = step_fn(state, batch)
        if wait:
            torch.cuda.synchronize(art.device)
        t1 = now()
        hist.observe(t1 - t0, job=job)
        if recorder is not None or on_record is not None:
            # map the closed-form timeline (backward-origin clock, total
            # span est.t_iter) onto the measured wall window [t0, t1]
            scale = (t1 - t0) / est.t_iter if est.t_iter > 0 else 0.0
            buckets = tuple(
                BucketRecord(bucket=e.bucket, nbytes=e.nbytes,
                             ready=t0 + (t_f + e.ready) * scale,
                             start=t0 + (t_f + e.start) * scale,
                             end=t0 + (t_f + e.end) * scale)
                for e in est.events)
            args = {"plan": fingerprint, "estimated_buckets": True,
                    "predicted_t_iter": est.t_iter,
                    "overlap_ratio": est.overlap_ratio}
            rec = IterationRecord(
                source=source, job=job, iteration=step_idx,
                start=t0, end=t1,
                backward_end=t0 + (t_f + est.t_b_total) * scale,
                buckets=buckets, args=args)
            if recorder is not None:
                recorder.record(rec)
            if on_record is not None:
                on_record(rec)
        step_idx += 1
        return out

    return wrapped
