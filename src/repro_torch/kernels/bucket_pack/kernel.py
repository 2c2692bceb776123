"""Merged-gradient pack/unpack kernels for Hopper (paper §5.3).

Replaces the Pallas kernels of ``repro/kernels/bucket_pack/kernel.py``:

* K1 :func:`pack` <- ``pack_kernel`` (body ``_make_pack_kernel``): packs a
  bucket's members into one flat buffer, each member zero-padded to a
  multiple of ``TILE`` and cast to the buffer's dtype, in a TILE-aligned
  slot.
* K2 :func:`unpack` <- ``unpack_one_kernel`` (body ``_copy_kernel``):
  copies every member back out of its slot with a cast, writing into the
  member tensors in place.

Both are CUDA C++ for ``sm_90a`` (``csrc/bucket_pack.cu``), built with
``nvcc`` on first use into ``build/`` beside this file and loaded with
``ctypes``.  Both are bandwidth-bound: the least time is the bytes read
plus the bytes written over the card's 3.35 TB/s.  The source explains the
design.

Beside each kernel is its plain PyTorch version (:func:`pack_plain`,
:func:`unpack_plain`).  A wrapper takes the plain version only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises.
Each wrapper counts its launches in :data:`launches`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

TILE = 512

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "bucket_pack.cu"
BUILD_DIR = _HERE / "build"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last reset, by kernel name.
launches = {"bucket_pack": 0, "bucket_unpack": 0}

_lib_handle = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def slot_elems(size: int) -> int:
    """Elements a member of ``size`` elements occupies: a TILE multiple."""
    return size + ((-size) % TILE)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and what the kernels are held to).
# ---------------------------------------------------------------------------

def pad_flat(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % TILE
    return F.pad(flat, (0, pad)) if pad else flat


def result_dtype(dtypes) -> torch.dtype:
    """Mixed-dtype buckets promote, as ``jnp.result_type`` does."""
    out = None
    for dt in dtypes:
        out = dt if out is None else torch.promote_types(out, dt)
    return out


def pack_plain(members: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
    """Pad-flat-cat: the TILE-aligned slot layout built with torch ops."""
    dtype = dtype or result_dtype(m.dtype for m in members)
    return torch.cat([pad_flat(m).to(dtype) for m in members])


def unpack_plain(buf: torch.Tensor, shapes, dtypes) -> list[torch.Tensor]:
    """Slice-view-cast: each member's slice of its slot, in its own dtype."""
    out, off = [], 0
    for shape, dt in zip(shapes, dtypes):
        size = 1
        for d in shape:
            size *= d
        out.append(buf[off:off + size].view(shape).to(dt))
        off += slot_elems(size)
    return out


def unpack_plain_into(members: Sequence[torch.Tensor],
                      buf: torch.Tensor) -> None:
    """:func:`unpack_plain`, written into ``members`` in place: what K2
    computes."""
    pieces = unpack_plain(buf, [m.shape for m in members],
                          [m.dtype for m in members])
    for m, piece in zip(members, pieces):
        m.copy_(piece)


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------

def build() -> tuple[Path, str]:
    """Compile ``csrc/bucket_pack.cu`` for sm_90a unless a library built
    from the same source exists.  Returns ``(library path, nvcc log)``; the
    log holds ``ptxas -v``'s register and spill report (empty when the
    library was already built)."""
    return _build.build(SOURCE, BUILD_DIR, "bucket_pack")


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE, BUILD_DIR, "bucket_pack")
        for fn in (lib.bucket_pack, lib.bucket_unpack):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.bucket_error_string.argtypes = [ctypes.c_int]
        lib.bucket_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


# ---------------------------------------------------------------------------
# Member tables and the wrappers.
# ---------------------------------------------------------------------------

class MemberTable:
    """One bucket's members and their TILE-aligned slots.

    On a CUDA device the table also lives on the card as rows of four
    int64 (data pointer, element count, slot offset, dtype code), the form
    the kernels read.  Build it once per plan; :meth:`check` asserts that
    the member storages it points at have not moved since.
    """

    def __init__(self, members: Sequence[torch.Tensor]):
        if not members:
            raise ValueError("empty bucket")
        self.members = list(members)
        self.device = self.members[0].device
        self.sizes = [m.numel() for m in self.members]
        self.offsets, acc = [], 0
        for m, n in zip(self.members, self.sizes):
            if m.device != self.device:
                raise ValueError(f"bucket spans {self.device} and {m.device}")
            self.offsets.append(acc)
            acc += slot_elems(n)
        self.total = acc
        self.ptrs = [m.data_ptr() for m in self.members]
        self.device_table = None
        if self.device.type == "cuda":
            rows = []
            for m, n, off in zip(self.members, self.sizes, self.offsets):
                if m.dtype not in _DTYPE_CODES:
                    raise TypeError(f"bucket_pack kernels take float32 or "
                                    f"bfloat16, got {m.dtype}")
                if not m.is_contiguous():
                    raise ValueError("bucket_pack kernels need contiguous "
                                     "members")
                rows.append([m.data_ptr(), n, off, _DTYPE_CODES[m.dtype]])
            self.device_table = torch.tensor(rows, dtype=torch.int64,
                                             device=self.device)

    def check(self, members: Sequence[torch.Tensor]) -> None:
        """Raise unless ``members`` are the storages the table points at."""
        if len(members) != len(self.ptrs) or any(
                m.data_ptr() != p or m.numel() != n
                for m, p, n in zip(members, self.ptrs, self.sizes)):
            raise RuntimeError("bucket member storage moved since its table "
                               "was built; keep gradients allocated and zero "
                               "them in place")


def _launch(fn, name: str, table: MemberTable, buf: torch.Tensor) -> None:
    if buf.device != table.device or buf.dtype not in _DTYPE_CODES \
            or not buf.is_contiguous() or buf.numel() != table.total \
            or buf.data_ptr() % 16:
        raise ValueError(f"{name}: buffer must be a contiguous, 16-byte "
                         f"aligned float32 or bfloat16 tensor of "
                         f"{table.total} elements on {table.device}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = fn(table.device_table.data_ptr(), len(table.members),
            buf.data_ptr(), _DTYPE_CODES[buf.dtype], table.total, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{_lib().bucket_error_string(rc).decode()}")
    launches[name] += 1


def pack(table: MemberTable, dtype=None) -> torch.Tensor:
    """K1: a new buffer holding the table's members in their slots."""
    dtype = dtype or result_dtype(m.dtype for m in table.members)
    if table.device.type == "cpu":
        return pack_plain(table.members, dtype)
    if table.device.type != "cuda":
        raise ValueError(f"bucket_pack: no kernel for {table.device}")
    buf = torch.empty(table.total, dtype=dtype, device=table.device)
    _launch(_lib().bucket_pack, "bucket_pack", table, buf)
    return buf


def unpack(table: MemberTable, buf: torch.Tensor) -> None:
    """K2: copy every member out of ``buf`` into the member tensors."""
    if table.device.type == "cpu":
        unpack_plain_into(table.members, buf)
        return
    if table.device.type != "cuda":
        raise ValueError(f"bucket_unpack: no kernel for {table.device}")
    _launch(_lib().bucket_unpack, "bucket_unpack", table, buf)
