"""Neural-net building blocks of the dense decoder (port of the dense
subset of ``repro.models.layers``).

Plain functions on tensors; parameters are plain dicts of tensors in the
reference's layout (``[d_in, d_out]`` weights, ``x @ w``), so the bridge
carries reference parameters over unchanged.  These are plain PyTorch, as
the reference computes them in jnp outside any kernel.

The attention core keeps the reference's two forms: :func:`attention_ref`
materializes the scores, and :func:`attention` runs the online softmax over
KV chunks when the keys outnumber ``chunk``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initializers.  The random draws are torch's, not jax.random's: parameters
# are compared across packages by carrying them over with ``bridge``.
# ---------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norm and rotary embeddings.
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given integer positions [.. S]."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2 / head_dim))
    freq = torch.from_numpy(np.asarray(freq, np.float32)).to(positions.device)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [S, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------

def _gqa_expand(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """[B,S,Hq,D] -> [B,S,Hkv,G,D]."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, num_kv, hq // num_kv, d)


def _mask(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """Full-materialization attention.  q: [B,Sq,Hq,D], k/v: [B,Skv,Hkv,D];
    GQA via head grouping; ``window > 0`` keeps keys with q_pos - k_pos in
    [0, window)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = _gqa_expand(q * scale, hkv)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    dev = q.device
    mask = _mask(q_offset + torch.arange(sq, device=dev),
                 torch.arange(skv, device=dev), causal, window)
    logits = torch.where(mask, logits, NEG_INF)
    # the softmax is shift-invariant: no gradient flows through the max
    m = logits.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(logits - m) * mask
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, chunk: int = 1024,
              scale: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient attention: online softmax over KV chunks.

    Never materializes more than [B, Sq, H, chunk] of scores; the same
    result as :func:`attention_ref`.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if skv <= chunk:
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = _gqa_expand(q.float() * scale, hkv)               # [B,Sq,K,G,D]
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    g = hq // hkv
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        start = c * chunk
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        logits = torch.einsum("bskgd,btkd->bkgst", qg, kb)
        k_pos = start + torch.arange(chunk, device=dev)
        mask = _mask(q_pos, k_pos, causal, window) & (k_pos < skv)[None, :]
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]              # [B,K,G,Sq,D]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLP and attention projections.
# ---------------------------------------------------------------------------

def mlp_apply(params: dict, x: torch.Tensor, act: str = "swiglu"
              ) -> torch.Tensor:
    """SwiGLU (w_gate/w_up/w_down) or GELU (w_up/w_down) MLP."""
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = x @ params["w_up"]
        if "b_up" in params:
            h = h + params["b_up"]
        h = F.gelu(h, approximate="tanh")
    out = h @ params["w_down"]
    if "b_down" in params:
        out = out + params["b_down"]
    return out


def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype, device,
             bias: bool = False) -> dict:
    p = {}
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    p["w_up"] = dense_init(gen, d_model, d_ff, dtype, device)
    p["w_down"] = dense_init(gen, d_ff, d_model, dtype, device)
    if bias:
        p["b_up"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_down"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def attn_init(gen, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype, device, qkv_bias: bool = False) -> dict:
    p = {
        "w_q": dense_init(gen, d_model, num_heads * head_dim, dtype, device),
        "w_k": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                          device),
        "w_v": dense_init(gen, d_model, num_kv_heads * head_dim, dtype,
                          device),
        "w_o": dense_init(gen, num_heads * head_dim, d_model, dtype, device),
    }
    if qkv_bias:
        p["b_q"] = torch.zeros((num_heads * head_dim,), dtype=dtype,
                               device=device)
        p["b_k"] = torch.zeros((num_kv_heads * head_dim,), dtype=dtype,
                               device=device)
        p["b_v"] = torch.zeros((num_kv_heads * head_dim,), dtype=dtype,
                               device=device)
    return p


def qkv_proj(params: dict, x: torch.Tensor, num_heads: int,
             num_kv_heads: int, head_dim: int):
    b, s, _ = x.shape
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if "b_q" in params:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    return (q.reshape(b, s, num_heads, head_dim),
            k.reshape(b, s, num_kv_heads, head_dim),
            v.reshape(b, s, num_kv_heads, head_dim))


def out_proj(params: dict, o: torch.Tensor) -> torch.Tensor:
    b, s, h, d = o.shape
    return o.reshape(b, s, h * d) @ params["w_o"]
