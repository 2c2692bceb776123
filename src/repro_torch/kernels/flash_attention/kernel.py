"""Flash attention forward kernel for Hopper.

Replaces the Pallas kernel of ``repro/kernels/flash_attention/kernel.py``:

* K4 :func:`flash_attention_bshd` <- ``flash_attention_kernel`` (body
  ``_kernel``): blockwise online-softmax attention with float32 m, l and
  accumulator; causal, sliding-window and padding masks; GQA; scale
  ``1/sqrt(D)``.

CUDA C++ for ``sm_90a`` (``csrc/flash_attention.cu``), built with ``nvcc``
on first use into ``build/`` beside this file and loaded with ``ctypes``.
Bound by operations: 4·D flops for each unmasked (query, key) pair.  The
kernels read q, k and v in their ``[B, S, H, D]`` layout through strides
and write o as ``[B, Sq, Hq, D]``; head dims 16, 32, 64, 96 and 128.  The
dtype picks the kernel: bfloat16 runs ``flash_fwd_tc`` on the tensor cores
(wgmma, with K/V tiles loaded by TMA), which rounds p to bfloat16 for the
p·v product; float32 runs the SIMT ``flash_fwd``, which keeps float32's
tolerance.  TMA needs a 16-byte aligned base and 16-byte strides, so the
wrapper refuses bfloat16 views without them.  The source explains the
design.

The wrapper takes the plain version (:func:`attention_plain`, the port's
copy of ``repro/kernels/flash_attention/ref.py``) only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  It counts its
launches in :data:`launches`.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "flash_attention.cu"
BUILD_DIR = _HERE / "build"

HEAD_DIMS = (16, 32, 64, 96, 128)
NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last reset.
launches = {"flash_attention": 0}

_lib_handle = None


def reset_launches() -> None:
    launches["flash_attention"] = 0


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The plain version, full materialization:
    ``repro/kernels/flash_attention/ref.py:attention_ref``.
    q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D] (GQA by head grouping)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, hkv, g, d).float() * scale
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA can map the bfloat16 ``[B, S, H, D]`` view ``t``: a
    16-byte aligned base, and strides of 16-byte multiples in every dim
    that is ever stepped (extent > 1)."""
    return t.data_ptr() % 16 == 0 and all(
        st * 2 % 16 == 0 for st, n in zip(t.stride()[:3], t.shape[:3])
        if n > 1)


def build() -> tuple[Path, str]:
    """Compile ``csrc/flash_attention.cu`` unless built; ``(library, nvcc
    log)``."""
    return _build.build(SOURCE, BUILD_DIR, "flash_attention")


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(SOURCE, BUILD_DIR, "flash_attention")
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.flash_attention.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i,
            ctypes.POINTER(ctypes.c_longlong), i, i, ctypes.c_float, p]
        lib.flash_attention.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """K4: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] -> o [B, Sq, Hq, D]."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return attention_plain(q, k, v, causal=causal, window=window)
    if len(devices) != 1 or q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: q, k and v on "
                           f"{[str(t.device) for t in (q, k, v)]}; the kernel "
                           f"needs all three on one CUDA device")
    if k.shape != (b, skv, hkv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match as [B, S, H, D]")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not supported on "
                         f"the card (one of {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must all be float32 "
                        f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous "
                         "(unit stride)")
    if q.dtype == torch.bfloat16 and not all(map(_tma_ok, (q, k, v))):
        raise ValueError("flash_attention: bfloat16 q, k and v need a "
                         "16-byte aligned base and strides that are "
                         "multiples of 16 bytes (the kernel loads them "
                         "with TMA)")
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o)
                                         for s in t.stride()[:3]))
    lib = _lib()
    rc = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[q.dtype], b, sq, skv, hq, hkv, d, strides, int(causal),
        int(window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention")
    launches["flash_attention"] += 1
    return o
