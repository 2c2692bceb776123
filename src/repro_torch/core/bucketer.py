"""Bucket assembly: gradient trees <-> flat merged buffers.

Port of ``repro.core.bucketer``.  The paper's §5.3 pre-allocates one
contiguous buffer per merged-gradient group and copies each member tensor
into it so a single all-reduce covers the whole group; after the
collective the buffer is split back into the original shapes.

Ordering: gradients are communicated in *backward production order*, the
reverse of the tree's flatten order (sorted dict keys, list order), so a
:class:`MergePlan` indexes the same tensors here as in the reference.  The
path strings are ``jax.tree_util.keystr``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.planner import MergePlan, TensorSpec
from repro_torch.kernels.bucket_pack import kernel as bp_kernel
from repro_torch.utils import tree


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    """Metadata for one gradient leaf in backward order."""

    path: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    size: int           # elements
    nbytes: int


def leaves_in_backward_order(params) -> list[tuple[str, Any]]:
    """(path, leaf) pairs, reversed flatten order.

    Within a block that is ``norm2, norm1, mlp, attn``; after the blocks
    come ``final_norm`` and then ``embed``.
    """
    return list(reversed(tree.flatten_with_path(params)))


def leaf_metadata(params) -> list[LeafMeta]:
    out = []
    for path, leaf in leaves_in_backward_order(params):
        shape = tuple(leaf.shape)
        size = 1
        for d in shape:
            size *= d
        out.append(LeafMeta(path, shape, leaf.dtype, size,
                            size * leaf.dtype.itemsize))
    return out


def tensor_specs(params, t_b_fn: Callable[[LeafMeta], float]
                 ) -> list[TensorSpec]:
    """Build planner inputs from a parameter tree and a timing model."""
    return [TensorSpec(m.path, m.nbytes, t_b_fn(m))
            for m in leaf_metadata(params)]


# ---------------------------------------------------------------------------
# Pack / unpack.
#
# Two buffer layouts share one contract:
#   * plain (``use_kernel=False``): leaves concatenated back to back;
#   * slot-aligned (``use_kernel=True``): each leaf occupies a TILE-aligned
#     slot (zero-padded tail), the layout the bucket_pack kernels emit.
# ---------------------------------------------------------------------------

def slot_elems(size: int, aligned: bool = False) -> int:
    """Elements a leaf of ``size`` occupies in the packed buffer."""
    return bp_kernel.slot_elems(size) if aligned else size


def packed_elems(metas: Sequence[LeafMeta], aligned: bool = False) -> int:
    """Total packed-buffer elements for a bucket under either layout."""
    return sum(slot_elems(m.size, aligned) for m in metas)


def pack(leaves: Sequence[torch.Tensor], dtype=None,
         use_kernel: bool = False) -> torch.Tensor:
    """Concatenate leaves into one flat buffer (paper §5.3 merged buffer)."""
    if not leaves:
        raise ValueError("empty bucket")
    dtype = dtype or bp_kernel.result_dtype(l.dtype for l in leaves)
    if use_kernel:
        from repro_torch.kernels.bucket_pack import ops as pack_ops
        return pack_ops.pack(list(leaves), dtype)
    return torch.cat([l.reshape(-1).to(dtype) for l in leaves])


def unpack(buf: torch.Tensor, metas: Sequence[LeafMeta],
           use_kernel: bool = False) -> list[torch.Tensor]:
    """Split a flat buffer back into the bucket's member tensors."""
    expected = packed_elems(metas, aligned=use_kernel)
    if expected != buf.shape[0]:
        raise ValueError(f"buffer has {buf.shape[0]} elements, "
                         f"metas describe {expected}")
    if use_kernel:
        from repro_torch.kernels.bucket_pack import ops as pack_ops
        return pack_ops.unpack(buf, [m.shape for m in metas],
                               [m.dtype for m in metas])
    out, off = [], 0
    for m in metas:
        out.append(buf[off:off + m.size].view(m.shape).to(m.dtype))
        off += m.size
    return out


def apply_bucketed(grads, plan: MergePlan,
                   collective: Callable[[torch.Tensor], torch.Tensor],
                   comm_dtype=None, use_kernel: bool = False):
    """Apply ``collective`` to each merged bucket of a gradient tree.

    The collective sees exactly one flat buffer per bucket, in plan order
    (backward order).  Returns a new tree of the same structure.  The
    train step does not call this: it overlaps the buckets with backward
    through ``core.comm.BucketedAllReduce``.
    """
    metas = leaf_metadata(grads)                     # backward order
    if plan.num_tensors != len(metas):
        raise ValueError(
            f"plan covers {plan.num_tensors} tensors but tree has {len(metas)}")
    by_path = dict(tree.flatten_with_path(grads))
    out: dict[str, torch.Tensor] = {}
    for bucket in plan.buckets:
        bmetas = [metas[i] for i in bucket]
        arrs = [by_path[m.path] for m in bmetas]
        buf = pack(arrs, dtype=comm_dtype or arrs[0].dtype,
                   use_kernel=use_kernel)
        buf = collective(buf)
        wire_metas = [dataclasses.replace(mm, dtype=buf.dtype) for mm in bmetas]
        for m, arr in zip(bmetas, unpack(buf, wire_metas,
                                         use_kernel=use_kernel)):
            out[m.path] = arr.to(m.dtype)
    return tree.map_with_path(lambda path, _leaf: out[path], grads)
