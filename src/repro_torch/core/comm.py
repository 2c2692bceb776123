"""Bucketed collectives on ``torch.distributed``: the runtime half of MG-WFBP.

Port of the packed-mode parts of ``repro.core.comm``.  Entry points:

* :func:`bucketed_allreduce` reduces an already computed gradient tree
  bucket by bucket, in plan order (no overlap with backward).
* ZeRO-1's pair, also without overlap: :func:`bucketed_reduce_scatter`
  leaves each rank one shard of every reduced bucket, and
  :func:`bucketed_allgather` gathers updated shards back into a tree.
* :class:`BucketedAllReduce` is what the train step runs: it overlaps the
  buckets with backward.  In the reference XLA schedules that overlap
  after ``value_and_grad``; here it is explicit.  A post-accumulate-grad
  hook marks a leaf ready; once every member of the next bucket in plan
  order is ready, the bucket is packed (K1) on a communication stream and
  its collective is issued asynchronously: an all-reduce (ZeRO-0) or a
  reduce-scatter (ZeRO-1).  After backward, :meth:`finish` waits on every
  handle and unpacks (K2) into the gradients in place, or keeps the
  shards for ZeRO-1's sharded update.
* :class:`BucketedAllGather` is ZeRO-1's parameter half in the train
  step: each bucket's parameters packed (K1), this rank's shard updated by
  the caller, all-gathered, and unpacked (K2) into the parameters.

Buckets are issued strictly in plan order: NCCL needs the same collective
order on every rank, and autograd's readiness order is not the plan's.
The collective is NCCL on the card and gloo on the CPU (no side stream).
With the kernel flag every pack and unpack goes through
``bp_kernel.pack`` and ``bp_kernel.unpack``, once per bucket per pass.
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


# ---------------------------------------------------------------------------
# One bucket's buffer, and ZeRO-1's reduce-scatter and all-gather.
# ---------------------------------------------------------------------------

def pack_bucket(members: Sequence[torch.Tensor], dtype, table=None
                ) -> torch.Tensor:
    """One flat buffer of ``members``: K1 into the TILE-aligned slots when
    ``table`` (their :class:`~repro_torch.kernels.bucket_pack.kernel.MemberTable`)
    is given, else concatenated back to back."""
    if table is not None:
        return bp_kernel.pack(table, dtype)
    return torch.cat([t.reshape(-1).to(dtype) for t in members])


def unpack_bucket(members: Sequence[torch.Tensor], buf: torch.Tensor,
                  table=None) -> None:
    """Inverse of :func:`pack_bucket`, written into ``members`` in place
    (K2 when ``table`` is given)."""
    if table is not None:
        bp_kernel.unpack(table, buf)
        return
    off = 0
    for t in members:
        n = t.numel()
        t.copy_(buf[off:off + n].view(t.shape))
        off += n


def bucket_shard_size(nelems: int, n: int) -> int:
    """Padded per-shard element count for a tiled collective over n shards."""
    return (nelems + n - 1) // n


def pad_to_shards(buf: torch.Tensor, n: int) -> torch.Tensor:
    """``buf`` zero-padded to a multiple of ``n`` elements, as the
    reference pads a bucket before its tiled reduce-scatter."""
    pad = (-buf.shape[0]) % n
    return torch.nn.functional.pad(buf, (0, pad)) if pad else buf


def _reduce_scatter(out, buf, group, async_op=False):
    # torch 2.13 renames reduce_scatter_tensor; older releases lack the new
    # name
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    return fn(out, buf, group=group, async_op=async_op)


def _all_gather(out, shard, group):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, shard, group=group)


def _scatter_shard(buf: torch.Tensor, group, world: int, wire_dtype,
                   async_op: bool = False):
    """Pad ``buf`` to ``world`` shards and reduce-scatter its sum; returns
    ``(wire shard, restore, work)``."""
    wire, restore = _wire_cast(buf, wire_dtype)
    wire = pad_to_shards(wire, world)
    out = torch.empty(wire.shape[0] // world, dtype=wire.dtype,
                      device=wire.device)
    work = _reduce_scatter(out, wire, group, async_op)
    return out, restore, work


def bucketed_reduce_scatter(grads, plan: MergePlan, group=None, *,
                            mean: bool = True, wire_dtype=None,
                            use_kernel: bool = False):
    """Reduce-scatter each bucket over the group; returns ``(shards,
    bucket_metas)``: per bucket, this rank's shard of the summed (then
    mean) packed buffer, and the bucket's leaf metadata.

    The caller runs the optimizer on the shards and then calls
    :func:`bucketed_allgather`.  ``use_kernel`` selects the TILE-aligned
    slot layout (K1); the all-gather must use the same flag, or shard
    offsets disagree.  Each bucket is padded to a multiple of the rank
    count, as the reference pads it.
    """
    metas = bucketer.leaf_metadata(grads)
    if plan.num_tensors != len(metas):
        raise ValueError(f"plan covers {plan.num_tensors} tensors but the "
                         f"tree has {len(metas)}")
    by_path = dict(tree.flatten_with_path(grads))
    world = dist.get_world_size(group)
    shards, bucket_metas = [], []
    for bucket in plan.buckets:
        bmetas = [metas[i] for i in bucket]
        buf = bucketer.pack([by_path[m.path] for m in bmetas],
                            use_kernel=use_kernel)
        out, restore, _ = _scatter_shard(buf, group, world, wire_dtype)
        shard = restore(out)
        shards.append(shard / world if mean and world > 1 else shard)
        bucket_metas.append(bmetas)
    return shards, bucket_metas


def bucketed_allgather(shards: Sequence[torch.Tensor], bucket_metas,
                       like, group=None, *, use_kernel: bool = False):
    """Gather updated shards back into a new tree shaped like ``like``
    (K2 unpacks each gathered bucket when ``use_kernel``)."""
    world = dist.get_world_size(group)
    out: dict[str, torch.Tensor] = {}
    for shard, bmetas in zip(shards, bucket_metas):
        full = torch.empty(shard.shape[0] * world, dtype=shard.dtype,
                           device=shard.device)
        _all_gather(full, shard.contiguous(), group)
        full = full[:bucketer.packed_elems(bmetas, aligned=use_kernel)]
        for m, arr in zip(bmetas, bucketer.unpack(full, bmetas,
                                                  use_kernel=use_kernel)):
            out[m.path] = arr
    return tree.map_with_path(lambda path, _leaf: out[path], like)


def collective_bytes_of_plan(plan: MergePlan,
                             specs_bytes: Sequence[int]) -> list[int]:
    """Per-bucket wire bytes."""
    return [sum(specs_bytes[i] for i in bucket) for bucket in plan.buckets]


@dataclasses.dataclass
class _InFlight:
    bucket: int
    wire: torch.Tensor          # the reduced buffer, or this rank's shard
    restore: Callable[[torch.Tensor], torch.Tensor]
    work: object


COLLECTIVES = ("all_reduce", "reduce_scatter")


class BucketedAllReduce:
    """Overlapped, hook-driven bucketed reduction of one gradient tree.

    ``grads`` is the tree of tensors that hold the gradients to reduce, in
    place: each parameter's ``.grad`` in the train step, or float32
    accumulators under microbatching.  Their storages must stay put for
    the life of the object (zero them in place, never set them to None):
    with ``use_kernel`` the member tables the kernels read are built here,
    once per plan.

    ``collective``: ``"all_reduce"`` (ZeRO-0) unpacks every reduced bucket
    into ``grads``; ``"reduce_scatter"`` (ZeRO-1) pads each bucket to a
    multiple of the rank count, and :meth:`finish` returns this rank's
    shard of every bucket, plan-aligned, for the sharded update.

    Per step: :meth:`start`, then :meth:`mark_ready` for every leaf (the
    hooks from :meth:`attach` do it during backward), then :meth:`finish`.
    ``issued`` lists the bucket indices in the order their collectives
    were issued during the current step.
    """

    def __init__(self, grads, plan: MergePlan, group=None, *,
                 mean: bool = True, wire_dtype=None, use_kernel: bool = False,
                 collective: str = "all_reduce"):
        if collective not in COLLECTIVES:
            raise ValueError(f"unknown collective {collective!r}")
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
        self.collective = collective
        self.paths = [m.path for m in metas]
        self.members = [[by_path[metas[i].path] for i in bucket]
                        for bucket in plan.buckets]
        self.device = self.members[0][0].device
        self.tables = [bp_kernel.MemberTable(ms) if use_kernel else None
                       for ms in self.members]
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
        self.handles: list = []

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

    def finish(self) -> list[torch.Tensor] | None:
        """Wait for every bucket, then unpack into the gradients in place;
        the caller's stream waits for all of it.  With the reduce-scatter,
        return this rank's shard of each bucket instead, in plan order."""
        self.armed = False
        if self._next != len(self._pending):
            raise RuntimeError(f"{len(self._pending) - self._next} buckets "
                               f"never became ready")
        shards = [None] * len(self._pending) \
            if self.collective == "reduce_scatter" else None
        with self._on_comm_stream():
            for f in self._inflight:
                f.work.wait()
                buf = f.restore(f.wire)
                if self.mean and self.world > 1:
                    buf.div_(self.world)
                if shards is not None:
                    shards[f.bucket] = buf
                else:
                    unpack_bucket(self.members[f.bucket], buf,
                                  self.tables[f.bucket])
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self._inflight = []
        return shards

    def check(self, grads) -> None:
        """Raise unless ``grads`` are the storages this object reduces."""
        by_path = dict(tree.flatten_with_path(grads))
        for k, ms in enumerate(self.members):
            now = [by_path[self.paths[i]] for i in self.plan.buckets[k]]
            if self.use_kernel:
                self.tables[k].check(now)
            elif any(a.data_ptr() != b.data_ptr() for a, b in zip(now, ms)):
                raise RuntimeError("gradient storage moved; zero gradients "
                                   "in place")

    def attach(self, params, on_grad: Callable[[int, torch.Tensor], None]
               | None = None) -> list:
        """Register a post-accumulate-grad hook on every leaf of ``params``
        (the same tree structure as ``grads``) that calls ``on_grad(i, p)``
        and then :meth:`mark_ready(i) <mark_ready>` while armed.  Returns
        the hook handles, which :meth:`detach` removes."""
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
        self.handles.extend(handles)
        return handles

    def detach(self) -> None:
        """Remove every hook :meth:`attach` registered.  A step that swaps
        in another plan detaches the old object first: its hooks would
        otherwise stay on the parameters beside the new plan's."""
        self.armed = False
        for h in self.handles:
            h.remove()
        self.handles = []

    # -- internals ---------------------------------------------------------

    def _on_comm_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _issue(self, k: int) -> None:
        members = self.members[k]
        # buffer dtype: the bucket's first member's for the all-reduce, as
        # the reference's apply_bucketed packs with ``orig_dtype``; the
        # promoted one for the reduce-scatter, as its bucketer.pack does
        dtype = members[0].dtype if self.collective == "all_reduce" else \
            bp_kernel.result_dtype(t.dtype for t in members)
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_comm_stream():
            buf = pack_bucket(members, dtype, self.tables[k])
            if self.collective == "reduce_scatter":
                wire, restore, work = _scatter_shard(
                    buf, self.group, self.world, self.wire_dtype,
                    async_op=True)
            else:
                wire, restore = _wire_cast(buf, self.wire_dtype)
                work = dist.all_reduce(wire, group=self.group, async_op=True)
        self._inflight.append(_InFlight(k, wire, restore, work))
        self.issued.append(k)


class BucketedAllGather:
    """ZeRO-1's parameter half of the train step, bucket by bucket.

    ``params`` is the parameter tree, updated in place; its storages must
    stay put.  Per bucket, :meth:`pack_shard` packs the bucket's
    parameters (K1 with ``use_kernel``) into a buffer padded to a multiple
    of the rank count and returns it with this rank's shard, a view the
    caller updates in place; :meth:`gather` all-gathers the shards and
    unpacks (K2) the gathered buffer into the parameters.
    """

    def __init__(self, params, plan: MergePlan, group=None, *,
                 use_kernel: bool = False):
        metas = bucketer.leaf_metadata(params)
        if plan.num_tensors != len(metas):
            raise ValueError(f"plan covers {plan.num_tensors} tensors but "
                             f"the tree has {len(metas)}")
        by_path = dict(tree.flatten_with_path(params))
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.members = [[by_path[metas[i].path] for i in bucket]
                        for bucket in plan.buckets]
        self.tables = [bp_kernel.MemberTable(ms) if use_kernel else None
                       for ms in self.members]
        #: per bucket: packed elements, and elements of one rank's shard
        self.totals = [bucketer.packed_elems([metas[i] for i in bucket],
                                             aligned=use_kernel)
                       for bucket in plan.buckets]
        self.shard_sizes = [bucket_shard_size(n, self.world)
                            for n in self.totals]

    def pack_shard(self, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        members = self.members[k]
        dtype = bp_kernel.result_dtype(t.dtype for t in members)
        buf = pad_to_shards(pack_bucket(members, dtype, self.tables[k]),
                            self.world)
        size = self.shard_sizes[k]
        return buf, buf[self.rank * size:(self.rank + 1) * size]

    def gather(self, k: int, buf: torch.Tensor, shard: torch.Tensor) -> None:
        """All-gather every rank's ``shard`` of bucket ``k`` into a buffer
        like ``buf`` and unpack it into the parameters."""
        full = torch.empty_like(buf)
        _all_gather(full, shard, self.group)
        unpack_bucket(self.members[k], full[:self.totals[k]], self.tables[k])

