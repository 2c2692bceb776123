"""Fused RMSNorm kernel for Hopper.

Replaces the Pallas kernel of ``repro/kernels/rmsnorm/kernel.py``:

* K3 :func:`rmsnorm_rows` <- ``rmsnorm_kernel`` (body ``_kernel``):
  ``x * rsqrt(mean(x**2) + eps) * scale`` over the rows of ``x [R, D]``,
  in float32, cast back to ``x.dtype``.

CUDA C++ for ``sm_90a`` (``csrc/rmsnorm.cu``), built with ``nvcc`` on
first use into ``build/`` beside this file and loaded with ``ctypes``.
Bandwidth-bound: the least time is the bytes of x, scale and y over the
card's 3.35 TB/s.  One warp per row reads x in place at any D and any
row stride, with no row padding (the padding was a TPU tiling need).  The
source explains the design.

The wrapper takes the plain version (:func:`rmsnorm_plain`, the port's copy
of ``repro/kernels/rmsnorm/ref.py``) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  It counts its launches in
:data:`launches`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

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


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE, BUILD_DIR, "rmsnorm")
        lib.rmsnorm.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
        lib.rmsnorm.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                 ) -> torch.Tensor:
    """K3 on ``x [R, D]`` (unit stride in D, any row stride) and ``scale
    [D]``; a new contiguous ``[R, D]`` tensor."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise RuntimeError(f"rmsnorm: x on {x.device} and scale on "
                           f"{scale.device}; the kernel needs both on one "
                           f"CUDA device")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x must be [R, D] and scale [D], got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm: float32 or bfloat16 only, got {x.dtype} "
                        f"and {scale.dtype}")
    if x.stride(1) != 1 or not scale.is_contiguous():
        raise ValueError("rmsnorm: x needs unit stride in D and scale must "
                         "be contiguous")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.rmsnorm(x.data_ptr(), _DTYPE_CODES[x.dtype], x.stride(0),
                     scale.data_ptr(), _DTYPE_CODES[scale.dtype], y.data_ptr(),
                     x.shape[0], x.shape[1], eps,
                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "rmsnorm")
    launches["rmsnorm"] += 1
    return y
