"""List-level pack/unpack on the TILE-aligned slot layout.

Port of ``repro.kernels.bucket_pack.ops``.  Each call builds a one-off
:class:`~repro_torch.kernels.bucket_pack.kernel.MemberTable` and makes one
kernel launch, whatever the member count: there is no 32-source chunking
and no probe-and-fallback.  The train step builds its tables once per plan
instead (``core.comm.BucketedAllReduce``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.bucket_pack import kernel as K


def pack(leaves, dtype=None) -> torch.Tensor:
    """Pack arbitrary-shaped leaves into one TILE-aligned flat buffer."""
    return K.pack(K.MemberTable([l.contiguous() for l in leaves]), dtype)


def unpack(buf: torch.Tensor, shapes, dtypes) -> list[torch.Tensor]:
    """Inverse of :func:`pack` (slot offsets recomputed from shapes)."""
    outs = [torch.empty(tuple(s), dtype=dt, device=buf.device)
            for s, dt in zip(shapes, dtypes)]
    K.unpack(K.MemberTable(outs), buf)
    return outs
