"""Data-parallel train step with MG-WFBP-scheduled gradient communication.

Port of ``repro.train.step`` (ZeRO-0).  Construction
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

The state is updated in place.  Each rank passes its own shard of the
batch (``global_batch / world`` sequences).  ZeRO-1/3, expert parallelism
and hierarchical collectives are not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.configs.base import RunConfig
from repro_torch.core import bucketer, comm, cost_model, planner, profiler
from repro_torch.models.transformer import LM
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


# ---------------------------------------------------------------------------
# Step builder.
# ---------------------------------------------------------------------------

def _check_supported(run: RunConfig) -> None:
    par = run.parallel
    if par.zero != 0:
        raise NotImplementedError(f"ZeRO-{par.zero} is not ported yet "
                                  f"(ROADMAP queue 1, item 9); use zero=0")
    if par.ep_axis:
        raise NotImplementedError("expert parallelism is not ported yet")
    if len(par.dp_axes) > 1:
        raise NotImplementedError("one data-parallel axis only: "
                                  "hierarchical collectives are not ported")


def build_train_step(model: LM, run: RunConfig, group=None,
                     strategy: str | None = None,
                     tb_table: dict | None = None, comm_model=None,
                     device="cuda"):
    """Returns ``(step_fn, init_fn, StepArtifacts)``.

    ``group`` is the data-parallel process group (default: the default
    group); it must be initialized unless ``run.parallel.dp_axes`` is
    empty, in which case nothing is reduced.  ``tb_table`` / ``comm_model``
    thread measured or assumed costs into the plan (see
    :func:`build_plan`).

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

    local_batch = max(run.shape.global_batch // max(world, 1), 1)
    micro = min(run.microbatch or local_batch, local_batch)
    n_micro = max(local_batch // micro, 1)

    # ------------------------------------------------------------------

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
        sync = None
        if reduce_grads:
            sync = comm.BucketedAllReduce(
                targets, plan, group, mean=True,
                wire_dtype=par.wire_dtype or None, use_kernel=use_kernel)
            acc_by_index = [t for _, t in
                            bucketer.leaves_in_backward_order(targets)]

            def last_micro(i, p):
                acc_by_index[i].add_(p.grad).div_(n_micro)

            sync.attach(params, None if n_micro == 1 else last_micro)
        return TrainState.create(params, opt.init(params), targets, sync)

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

    def step_fn(state: TrainState, batch):
        params = state.params
        p_leaves = tree.leaves(params)
        g_leaves = tree.leaves(state.grads)
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
        if sync is not None:
            with record_function("step/finish_buckets"):
                sync.finish()
        grads = state.grads
        with record_function("step/clip"):
            gnorm = oclip.global_norm(grads)
            oclip.clip_by_global_norm(grads, run.grad_clip, gnorm)
        lr = lr_fn(state.step)
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
                        world=world, n_micro=n_micro)
    return step_fn, init_fn, art
