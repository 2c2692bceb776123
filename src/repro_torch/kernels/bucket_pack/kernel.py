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

K1 reads a chunk list that a :class:`MemberTable` builds once per buffer
dtype (:func:`chunk_rows`): pieces of at most :data:`CHUNK_BYTES` of one
member each, split into a bulk list (same dtype, 16-byte aligned, a
16-byte multiple: Hopper's bulk asynchronous copies) and a register list
(casts, misaligned members, odd tails, the zeros of each slot's tail).
The table also keeps K1's packed C arguments, so that a launch costs
``torch.empty``, the raw stream and a three-argument ``ctypes`` call.

Beside each kernel is its plain PyTorch version (:func:`pack_plain`,
:func:`unpack_plain`).  A wrapper takes the plain version only for tensors
that lie on the CPU; for CUDA tensors it launches the kernel or raises.
Each wrapper counts its launches in :data:`launches`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

TILE = 512

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "bucket_pack.cu"
BUILD_DIR = _HERE / "build"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Largest chunk of K1's work list, in bytes: one bulk-copy stage of
#: ``csrc/bucket_pack.cu`` (STAGE_BYTES).
CHUNK_BYTES = 16384
#: Smallest chunk the builder cuts a small bucket into, to spread it over
#: more blocks.  Chunk sizes are multiples of 32 bytes, so that a chunk of
#: float32 source cut for a bfloat16 buffer still starts on 16 bytes.
MIN_CHUNK_BYTES = 2048
#: K1's blocks per SM (PACK_BLOCKS_PER_SM in the source).
PACK_BLOCKS_PER_SM = 3

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


class _PackArgs(ctypes.Structure):
    """``PackArgs`` of ``csrc/bucket_pack.cu``: what a table fixes for one
    buffer dtype."""
    _fields_ = [("bulk", ctypes.c_void_p), ("n_bulk", ctypes.c_longlong),
                ("reg", ctypes.c_void_p), ("n_reg", ctypes.c_longlong),
                ("buf_dtype", ctypes.c_int), ("unused", ctypes.c_int)]


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE, BUILD_DIR, "bucket_pack")
        p = ctypes.c_void_p
        lib.bucket_pack_chunks.argtypes = [p, ctypes.POINTER(_PackArgs), p]
        lib.bucket_pack_chunks.restype = ctypes.c_int
        lib.bucket_unpack.argtypes = [p, ctypes.c_int, p, ctypes.c_int,
                                      ctypes.c_longlong, p]
        lib.bucket_unpack.restype = ctypes.c_int
        lib.bucket_error_string.argtypes = [ctypes.c_int]
        lib.bucket_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def chunk_bytes(total_bytes: int, sms: int) -> int:
    """The builder's chunk size for a bucket of ``total_bytes``: the full
    :data:`CHUNK_BYTES` when the bucket fills every block with chunks of
    that size, else small enough to reach every block, down to
    :data:`MIN_CHUNK_BYTES`."""
    per_block = total_bytes // (sms * PACK_BLOCKS_PER_SM) // 32 * 32
    return max(MIN_CHUNK_BYTES, min(CHUNK_BYTES, per_block))


def chunk_rows(ptrs, sizes, dtypes, offsets, buf_dtype, cap_bytes: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """K1's work lists for one bucket and buffer dtype: ``(bulk, reg)``,
    int64 arrays of rows (source byte address, buffer element, n | zeros
    << 32, dtype code | vec << 32), the ``Chunk`` rows of the source.

    A member of the buffer's dtype at a 16-byte aligned address goes to
    the bulk list in chunks of ``cap_bytes``, up to its last whole 16
    bytes; the rest of it and its slot's zero tail make one register
    chunk.  Any other member goes to the register list in chunks of
    ``cap_bytes`` of the wider of its and the buffer's dtype, the last one
    carrying its slot's zero tail.  A zero-size member owns no slot and no
    chunk."""
    bulk, reg = [], []
    bsz = buf_dtype.itemsize

    def rows(src, dst, n, zeros, code, vec):
        return np.stack([src, dst, n | (zeros << 32),
                         np.full_like(src, code | (vec << 32))], axis=1)

    for ptr, n, dt, off in zip(ptrs, sizes, dtypes, offsets):
        if n == 0:
            continue
        esz, code, zeros = dt.itemsize, _DTYPE_CODES[dt], slot_elems(n) - n
        if dt == buf_dtype and ptr % 16 == 0:
            cap = cap_bytes // esz
            nb = n * esz // 16 * 16 // esz          # the whole 16 bytes
            starts = np.arange(0, nb, cap, dtype=np.int64)
            lens = np.minimum(cap, nb - starts)
            bulk.append(rows(ptr + starts * esz, off + starts, lens, 0,
                             code, 0))
            if nb < n or zeros:
                reg.append(rows(np.array([ptr + nb * esz]),
                                np.array([off + nb]), np.array([n - nb]),
                                zeros, code, 1))
            continue
        cap = cap_bytes // max(esz, bsz)
        starts = np.arange(0, n, cap, dtype=np.int64)
        lens = np.minimum(cap, n - starts)
        tail = np.where(starts + lens == n, zeros, 0)
        reg.append(rows(ptr + starts * esz, off + starts, lens, tail, code,
                        int(ptr % 16 == 0)))
    empty = np.zeros((0, 4), np.int64)
    return (np.concatenate(bulk) if bulk else empty,
            np.concatenate(reg) if reg else empty)


# ---------------------------------------------------------------------------
# Member tables and the wrappers.
# ---------------------------------------------------------------------------

class MemberTable:
    """One bucket's members and their TILE-aligned slots.

    On a CUDA device the table also lives on the card as rows of four
    int64 (data pointer, element count, slot offset, dtype code), the form
    K2 reads, and keeps K1's chunk lists and packed C arguments, one set
    per buffer dtype, built at the first pack into that dtype
    (``pack_args``).  Build it once per plan; :meth:`check` asserts that
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
        #: buffer dtype -> (K1's C arguments, the chunk lists they point at)
        self.pack_args: dict = {}
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


def _raise(name: str, rc: int) -> None:
    raise RuntimeError(f"{name} launch failed: "
                       f"{_lib().bucket_error_string(rc).decode()}")


def _pack_args(table: MemberTable, dtype: torch.dtype):
    """Build, keep on the table and return what K1 needs for ``dtype``:
    ``(C function, packed arguments, raw-stream getter, device index)``."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"bucket_pack: buffer must be float32 or bfloat16, "
                         f"got {dtype}")
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    cap = chunk_bytes(table.total * dtype.itemsize, sms)
    lists = [torch.from_numpy(rows).to(table.device) for rows in chunk_rows(
        table.ptrs, table.sizes, [m.dtype for m in table.members],
        table.offsets, dtype, cap)]
    args = _PackArgs(lists[0].data_ptr(), lists[0].shape[0],
                     lists[1].data_ptr(), lists[1].shape[0],
                     _DTYPE_CODES[dtype], 0)
    entry = (_lib().bucket_pack_chunks, ctypes.pointer(args),
             torch._C._cuda_getCurrentRawStream, table.device.index, lists)
    table.pack_args[dtype] = entry
    return entry


def pack(table: MemberTable, dtype=None) -> torch.Tensor:
    """K1: a new buffer holding the table's members in their slots."""
    dtype = dtype or result_dtype(m.dtype for m in table.members)
    if table.device.type == "cpu":
        return pack_plain(table.members, dtype)
    if table.device.type != "cuda":
        raise ValueError(f"bucket_pack: no kernel for {table.device}")
    fn, args, raw_stream, index, _ = \
        table.pack_args.get(dtype) or _pack_args(table, dtype)
    buf = torch.empty(table.total, dtype=dtype, device=table.device)
    rc = fn(buf.data_ptr(), args, raw_stream(index))
    if rc:
        _raise("bucket_pack", rc)
    launches["bucket_pack"] += 1
    return buf


def unpack(table: MemberTable, buf: torch.Tensor) -> None:
    """K2: copy every member out of ``buf`` into the member tensors."""
    if table.device.type == "cpu":
        unpack_plain_into(table.members, buf)
        return
    if table.device.type != "cuda":
        raise ValueError(f"bucket_unpack: no kernel for {table.device}")
    if buf.device != table.device or buf.dtype not in _DTYPE_CODES \
            or not buf.is_contiguous() or buf.numel() != table.total \
            or buf.data_ptr() % 16:
        raise ValueError(f"bucket_unpack: buffer must be a contiguous, "
                         f"16-byte aligned float32 or bfloat16 tensor of "
                         f"{table.total} elements on {table.device}")
    rc = _lib().bucket_unpack(
        table.device_table.data_ptr(), len(table.members), buf.data_ptr(),
        _DTYPE_CODES[buf.dtype], table.total,
        torch._C._cuda_getCurrentRawStream(table.device.index))
    if rc:
        _raise("bucket_unpack", rc)
    launches["bucket_unpack"] += 1
