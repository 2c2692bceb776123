"""Bucketed all-reduce on ``torch.distributed``: the runtime half of MG-WFBP.

Port of the packed-mode parts of ``repro.core.comm``.  Two entry points:

* :func:`bucketed_allreduce` reduces an already computed gradient tree
  bucket by bucket, in plan order (no overlap with backward).
* :class:`BucketedAllReduce` is what the train step runs: it overlaps the
  buckets with backward.  In the reference XLA schedules that overlap
  after ``value_and_grad``; here it is explicit.  A post-accumulate-grad
  hook marks a leaf ready; once every member of the next bucket in plan
  order is ready, the bucket is packed (K1) on a communication stream and
  its all-reduce is issued asynchronously.  After backward, :meth:`finish`
  waits on every handle and unpacks (K2) into the gradients in place.

Buckets are issued strictly in plan order: NCCL needs the same collective
order on every rank, and autograd's readiness order is not the plan's.
The collective is NCCL on the card and gloo on the CPU (no side stream).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import bucketer
from repro_torch.core.planner import MergePlan
from repro_torch.kernels.bucket_pack import kernel as bp_kernel
from repro_torch.utils import tree


def _wire_cast(buf: torch.Tensor, wire_dtype
               ) -> tuple[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]:
    """Optionally compress the on-wire representation (e.g. bf16)."""
    if wire_dtype is None:
        return buf, lambda y: y
    wire_dtype = getattr(torch, wire_dtype) if isinstance(wire_dtype, str) \
        else wire_dtype
    if buf.dtype == wire_dtype:
        return buf, lambda y: y
    orig = buf.dtype
    return buf.to(wire_dtype), lambda y: y.to(orig)


def _reduce(buf: torch.Tensor, group, world: int, mean: bool, wire_dtype):
    """Synchronous sum (then mean, in the buffer's dtype) of one buffer."""
    wire, restore = _wire_cast(buf, wire_dtype)
    dist.all_reduce(wire, group=group)
    out = restore(wire)
    return out / world if mean and world > 1 else out


def bucketed_allreduce(grads, plan: MergePlan, group=None, *,
                       mean: bool = True, wire_dtype=None,
                       mode: str = "packed", use_kernel: bool = False):
    """All-reduce a gradient tree bucket by bucket; returns a new tree.

    ``mode="packed"`` (paper §5.3): each bucket's members are copied into
    one contiguous buffer, in the TILE-aligned slot layout through the
    bucket_pack kernels when ``use_kernel``, and one all-reduce runs per
    bucket.  ``mode="fused"`` is the reference's one variadic ``psum`` per
    bucket; NCCL has no variadic all-reduce, so it maps onto the packed
    path with the plain (concatenated) layout.  The mean is taken in the
    buffer's dtype after the sum, as the reference does.
    """
    if mode not in ("packed", "fused"):
        raise ValueError(f"unknown mode {mode!r}")
    world = dist.get_world_size(group)
    return bucketer.apply_bucketed(
        grads, plan, lambda buf: _reduce(buf, group, world, mean, wire_dtype),
        use_kernel=use_kernel and mode == "packed")


def collective_bytes_of_plan(plan: MergePlan,
                             specs_bytes: Sequence[int]) -> list[int]:
    """Per-bucket wire bytes."""
    return [sum(specs_bytes[i] for i in bucket) for bucket in plan.buckets]


@dataclasses.dataclass
class _InFlight:
    bucket: int
    wire: torch.Tensor
    restore: Callable[[torch.Tensor], torch.Tensor]
    work: object


class BucketedAllReduce:
    """Overlapped, hook-driven bucketed all-reduce of one gradient tree.

    ``grads`` is the tree of tensors that hold the gradients to reduce, in
    place: each parameter's ``.grad`` in the train step, or float32
    accumulators under microbatching.  Their storages must stay put for
    the life of the object (zero them in place, never set them to None):
    with ``use_kernel`` the member tables the kernels read are built here,
    once per plan.

    Per step: :meth:`start`, then :meth:`mark_ready` for every leaf (the
    hooks from :meth:`attach` do it during backward), then :meth:`finish`.
    ``issued`` lists the bucket indices in the order their collectives
    were issued during the current step.
    """

    def __init__(self, grads, plan: MergePlan, group=None, *,
                 mean: bool = True, wire_dtype=None, use_kernel: bool = False):
        metas = bucketer.leaf_metadata(grads)
        if plan.num_tensors != len(metas):
            raise ValueError(f"plan covers {plan.num_tensors} tensors but "
                             f"the tree has {len(metas)}")
        by_path = dict(tree.flatten_with_path(grads))
        self.plan = plan
        self.group = group
        self.world = dist.get_world_size(group)
        self.mean = mean
        self.wire_dtype = wire_dtype
        self.use_kernel = use_kernel
        self.paths = [m.path for m in metas]
        self.members = [[by_path[metas[i].path] for i in bucket]
                        for bucket in plan.buckets]
        self.device = self.members[0][0].device
        self.tables = ([bp_kernel.MemberTable(ms) for ms in self.members]
                       if use_kernel else None)
        self._bucket_of = plan.bucket_of()
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            for ms in self.members:
                for t in ms:
                    t.record_stream(self.stream)
        self.issued: list[int] = []
        self._pending: list[int] = []
        self._next = 0
        self._inflight: list[_InFlight] = []
        self.armed = False

    # -- per step ----------------------------------------------------------

    def start(self) -> None:
        """Arm the hooks for one backward pass."""
        if self._inflight:
            raise RuntimeError("previous step's buckets were never finished")
        self._pending = [len(b) for b in self.plan.buckets]
        self._next = 0
        self.issued = []
        self.armed = True

    def mark_ready(self, i: int) -> None:
        """Leaf ``i`` (backward order) holds its final gradient; issue every
        bucket, in plan order, whose members are now all ready."""
        k = self._bucket_of[i]
        self._pending[k] -= 1
        if self._pending[k] < 0:
            raise RuntimeError(f"leaf {self.paths[i]} marked ready twice")
        while self._next < len(self._pending) and \
                self._pending[self._next] == 0:
            self._issue(self._next)
            self._next += 1

    def finish(self) -> None:
        """Wait for every bucket, then unpack into the gradients in place;
        the caller's stream waits for all of it."""
        self.armed = False
        if self._next != len(self._pending):
            raise RuntimeError(f"{len(self._pending) - self._next} buckets "
                               f"never became ready")
        with self._on_comm_stream():
            for f in self._inflight:
                f.work.wait()
                buf = f.restore(f.wire)
                if self.mean and self.world > 1:
                    buf.div_(self.world)
                if self.use_kernel:
                    bp_kernel.unpack(self.tables[f.bucket], buf)
                else:
                    off = 0
                    for t in self.members[f.bucket]:
                        n = t.numel()
                        t.copy_(buf[off:off + n].view(t.shape))
                        off += n
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self._inflight = []

    def check(self, grads) -> None:
        """Raise unless ``grads`` are the storages this object reduces."""
        by_path = dict(tree.flatten_with_path(grads))
        for k, ms in enumerate(self.members):
            now = [by_path[self.paths[i]] for i in self.plan.buckets[k]]
            if self.tables is not None:
                self.tables[k].check(now)
            elif any(a.data_ptr() != b.data_ptr() for a, b in zip(now, ms)):
                raise RuntimeError("gradient storage moved; zero gradients "
                                   "in place")

    def attach(self, params, on_grad: Callable[[int, torch.Tensor], None]
               | None = None) -> list:
        """Register a post-accumulate-grad hook on every leaf of ``params``
        (the same tree structure as ``grads``) that calls ``on_grad(i, p)``
        and then :meth:`mark_ready(i) <mark_ready>` while armed.  Returns
        the hook handles."""
        metas = bucketer.leaf_metadata(params)
        if [m.path for m in metas] != self.paths:
            raise ValueError("params and grads trees differ")
        by_path = dict(tree.flatten_with_path(params))
        handles = []
        for i, m in enumerate(metas):
            def hook(p, i=i):
                if not self.armed:
                    return
                if on_grad is not None:
                    on_grad(i, p)
                self.mark_ready(i)
            handles.append(
                by_path[m.path].register_post_accumulate_grad_hook(hook))
        return handles

    # -- internals ---------------------------------------------------------

    def _on_comm_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _issue(self, k: int) -> None:
        members = self.members[k]
        # buffer dtype: the bucket's first member's, as the reference's
        # apply_bucketed packs with ``orig_dtype``
        dtype = members[0].dtype
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_comm_stream():
            if self.use_kernel:
                buf = bp_kernel.pack(self.tables[k], dtype)
            else:
                buf = torch.cat([t.reshape(-1).to(dtype) for t in members])
            wire, restore = _wire_cast(buf, self.wire_dtype)
            work = dist.all_reduce(wire, group=self.group, async_op=True)
        self._inflight.append(_InFlight(k, wire, restore, work))
        self.issued.append(k)
