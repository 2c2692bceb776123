"""Fused RMSNorm kernel for Hopper.

Replaces the Pallas kernel of ``repro/kernels/rmsnorm/kernel.py``:

* K3 :func:`rmsnorm_rows` <- ``rmsnorm_kernel`` (body ``_kernel``):
  ``x * rsqrt(mean(x**2) + eps) * scale`` over the rows of ``x [..., D]``,
  in float32, cast back to ``x.dtype``.

CUDA C++ for ``sm_90a`` (``csrc/rmsnorm.cu``), built with ``nvcc`` on
first use into ``build/`` beside this file and loaded with ``ctypes``.
Bandwidth-bound: the least time is the bytes of x, scale and y over the
card's 3.35 TB/s.  One warp per row reads x in place at any D and any
row stride, with no row padding (the padding was a TPU tiling need).  The
source explains the design.

The kernel runs near its bound, so a call's cost is the host's: the
wrapper validates a call signature (shapes, strides, dtypes, devices, eps)
once in :func:`_check` and keeps the packed C arguments it fixes, so that
a repeated signature costs a dict lookup, ``torch.empty_like``, the raw
stream and a five-argument ``ctypes`` call.  An unseen signature runs
every check and raises as before.

The wrapper takes the plain version (:func:`rmsnorm_plain`, the port's copy
of ``repro/kernels/rmsnorm/ref.py``) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  It counts its launches in
:data:`launches`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "rmsnorm.cu"
BUILD_DIR = _HERE / "build"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last reset.
launches = {"rmsnorm": 0}

_lib_handle = None


def reset_launches() -> None:
    launches["rmsnorm"] = 0


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """The plain version: ``repro/kernels/rmsnorm/ref.py:rmsnorm_ref``."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def build() -> tuple[Path, str]:
    """Compile ``csrc/rmsnorm.cu`` unless built; ``(library, nvcc log)``."""
    return _build.build(SOURCE, BUILD_DIR, "rmsnorm")


class _Args(ctypes.Structure):
    """``RmsnormArgs`` of ``csrc/rmsnorm.cu``: what a signature fixes."""
    _fields_ = [("x_stride", ctypes.c_longlong), ("rows", ctypes.c_longlong),
                ("x_dt", ctypes.c_int), ("scale_dt", ctypes.c_int),
                ("d", ctypes.c_int), ("eps", ctypes.c_float)]


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE, BUILD_DIR, "rmsnorm")
        p = ctypes.c_void_p
        lib.rmsnorm_packed.argtypes = [p, p, p, ctypes.POINTER(_Args), p]
        lib.rmsnorm_packed.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def _row_stride(x: torch.Tensor) -> Optional[int]:
    """The element stride between consecutive rows of ``x [..., D]`` read
    as ``[R, D]``, or None where the leading dims do not step by one stride
    (only a copy could make such rows)."""
    row, step = x.shape[-1], None
    for n, st in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if n == 1:
            continue
        if step is None:
            row = st
        elif st != step:
            return None
        step = st * n
    return row


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    """Every refusal of the kernel path, in one place: raises on what the
    kernel does not take, else returns the row stride of ``x``."""
    if x.dim() == 0:
        raise ValueError("rmsnorm: x must be [..., D], got a scalar")
    if scale.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: scale must be [D] for x "
                         f"{tuple(x.shape)}, got {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: float32 or bfloat16 only, got {x.dtype} "
                        f"and {scale.dtype}")
    if x.stride(-1) != 1 or not scale.is_contiguous():
        raise ValueError("rmsnorm: x needs unit stride in D and scale must "
                         "be contiguous")
    row_stride = _row_stride(x)
    if row_stride is None:
        raise ValueError(f"rmsnorm: the rows of x (shape {tuple(x.shape)}, "
                         f"strides {x.stride()}) are not one stride apart")
    if x.device.type != "cuda" or scale.device != x.device:
        raise RuntimeError(f"rmsnorm: x on {x.device} and scale on "
                           f"{scale.device}; the kernel needs both on one "
                           f"CUDA device")
    return row_stride


#: Validated call signatures -> what a launch needs beyond the pointers.
_signatures: dict = {}
_MAX_SIGNATURES = 256


def _signature(x: torch.Tensor, scale: torch.Tensor, eps: float, key):
    """Check an unseen signature and keep ``(C function, packed arguments,
    raw-stream getter, device index)`` for it."""
    row_stride = _check(x, scale)
    args = _Args(row_stride, x.numel() // max(x.shape[-1], 1),
                 _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
                 x.shape[-1], eps)
    if len(_signatures) >= _MAX_SIGNATURES:
        _signatures.clear()
    sig = (_lib().rmsnorm_packed, ctypes.pointer(args),
           torch._C._cuda_getCurrentRawStream, x.device.index)
    _signatures[key] = sig
    return sig


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                 ) -> torch.Tensor:
    """K3 over the rows of ``x [..., D]`` (unit stride in D, rows one
    stride apart) with ``scale [D]``; a new tensor of x's shape."""
    if x.is_cpu and scale.is_cpu:
        return rmsnorm_plain(x, scale, eps)
    key = (x.shape, x.stride(), x.dtype, x.device, scale.shape,
           scale.stride(), scale.dtype, scale.device, eps)
    sig = _signatures.get(key) or _signature(x, scale, eps, key)
    fn, args, raw_stream, index = sig
    # rows one stride apart: empty_like keeps a dense x's row-major layout
    # and makes any other x's output contiguous, rows d apart either way
    y = torch.empty_like(x)
    rc = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), args,
            raw_stream(index))
    if rc:
        _build.check(_lib(), rc, "rmsnorm")
    launches["rmsnorm"] += 1
    return y
