"""Dense decoder-only LM (port of the dense, unscanned path of
``repro.models.transformer.LM``).

The parameter tree has the reference's layout and path strings:
``{"embed", "stages": [{"blk00": {"norm1", "attn", "norm2", "mlp"}}, ...],
"final_norm"}`` with one stage per block (``scan_layers=False``).  With
``remat`` set, each block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``), which changes no numbers.

Entry points:

* ``loss(params, batch)``: the training objective, on the plain
  ``layers.rms_norm`` and ``layers.attention`` (the kernels below are
  forward-only, as in the reference).
* ``prefill(params, batch, max_len)`` -> (last-token logits [B, V], cache).
* ``decode_step(params, cache, tokens, pos)`` -> (logits [B, 1, V], cache).

The serving forward (``prefill`` and ``decode_step``) runs every norm
through the RMSNorm kernel (K3, ``kernels.rmsnorm``) and prefill's causal
self-attention through the flash-attention kernel (K4,
``kernels.flash_attention``).  Decode attention over the cache stays plain
PyTorch (``_masked_decode_attend``), as the reference computes it in jnp.

KV caches: a list parallel to the stages of ``{"blk00": {"k", "v",
"slot_pos"}}``; k/v are ``[B, cache_len, Hkv, Dh]`` with rope applied at
write time, and sliding-window layers use a ring buffer of ``window`` slots
with a slot -> position table.  ``decode_step`` writes the new token's k, v
and slot position into the cache in place and returns it (the reference
returns a new cache; in place saves a copy of the cache per step).

MoE, Mamba, xLSTM, encoder-decoder, scanned stacks, cross-attention caches
and the recurrent caches are not ported yet (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import layers

AUX_LOSS_COEF = 0.01


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class LM:
    """Decoder-only language model on a plain parameter tree."""

    def __init__(self, cfg: ModelConfig,
                 parallel: ParallelConfig = ParallelConfig()):
        if cfg.family != "dense" or cfg.enc_dec or cfg.frontend:
            raise NotImplementedError(
                f"{cfg.name}: only the dense decoder is ported "
                f"(ROADMAP queue 1, item 10)")
        if parallel.scan_layers:
            raise NotImplementedError(
                "scanned layer stacks are not ported; use scan_layers=False")
        self.cfg = cfg
        self.parallel = parallel
        self.kinds = [self._block_kind(i) for i in range(cfg.num_layers)]

    def _block_kind(self, layer_idx: int) -> dict:
        k = self.cfg.block_kind(layer_idx)
        if k["mixer"] != "attn" or k["ffn"] != "dense":
            raise NotImplementedError(f"block kind {k} is not ported")
        k["causal"] = True
        return k

    # ------------------------------------------------------------------
    # Init.
    # ------------------------------------------------------------------

    def _block_init(self, gen, device) -> dict:
        cfg = self.cfg
        dt = _dtype(cfg)
        d, hd = cfg.d_model, cfg.resolved_head_dim
        return {
            "norm1": torch.ones((d,), dtype=dt, device=device),
            "attn": layers.attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                     hd, dt, device, cfg.qkv_bias),
            "norm2": torch.ones((d,), dtype=dt, device=device),
            "mlp": layers.mlp_init(gen, d, cfg.d_ff, cfg.act, dt, device),
        }

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> dict:
        """Random parameters drawn from ``generator`` (which must live on
        ``device``; None draws from torch's default generator).  On the
        ``meta`` device this builds shapes only."""
        cfg = self.cfg
        dt = _dtype(cfg)
        params = {
            "embed": layers.embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dt, device),
            "stages": [{"blk00": self._block_init(generator, device)}
                       for _ in self.kinds],
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.dense_init(generator, cfg.d_model,
                                                  cfg.vocab_size, dt, device)
        return params

    # ------------------------------------------------------------------
    # Blocks.
    # ------------------------------------------------------------------

    def _norm(self, x, scale, serve: bool):
        """The serving forward's norms run K3; training keeps the plain
        ``layers.rms_norm`` (K3 has no backward)."""
        if serve:
            return rn_ops.rmsnorm(x, scale, eps=self.cfg.norm_eps)
        return layers.rms_norm(x, scale, self.cfg.norm_eps)

    def _attn_train(self, bp, x, kind, rope, serve: bool = False):
        """Returns ``(x, (k, v))``: k already rope'd at its position."""
        cfg, par = self.cfg, self.parallel
        hd = cfg.resolved_head_dim
        h = self._norm(x, bp["norm1"], serve)
        q, k, v = layers.qkv_proj(bp["attn"], h, cfg.num_heads,
                                  cfg.num_kv_heads, hd)
        cos, sin = rope
        q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
        if serve:
            o = fa_ops.flash_attention(q, k, v, causal=kind["causal"],
                                       window=kind["window"])
        else:
            o = layers.attention(q, k, v, causal=kind["causal"],
                                 window=kind["window"], chunk=par.attn_chunk)
        return x + layers.out_proj(bp["attn"], o), (k, v)

    def _ffn_half(self, bp, x, serve: bool = False):
        cfg = self.cfg
        h = self._norm(x, bp["norm2"], serve)
        return x + layers.mlp_apply(bp["mlp"], h, cfg.act)

    def _block_train(self, bp, x, kind, cos, sin, serve: bool = False):
        x, kv = self._attn_train(bp, x, kind, (cos, sin), serve)
        return self._ffn_half(bp, x, serve), kv

    def _run_stages(self, params, x, rope, collect_states: bool = False):
        """Returns ``(x, states)``.  With ``collect_states`` (prefill) this
        is the serving forward, on the kernels, and ``states`` lists each
        stage's ``{"blk00": {"kv": (k, v)}}``; else ``states`` is None."""
        remat = self.parallel.remat in ("block", "alternating") \
            and torch.is_grad_enabled()
        cos, sin = rope
        states = [] if collect_states else None
        for kind, sp in zip(self.kinds, params["stages"]):
            bp = sp["blk00"]
            if remat:
                x, kv = checkpoint(self._block_train, bp, x, kind, cos, sin,
                                   collect_states, use_reentrant=False)
            else:
                x, kv = self._block_train(bp, x, kind, cos, sin,
                                          collect_states)
            if collect_states:
                states.append({"blk00": {"kv": kv}})
        return x, states

    # ------------------------------------------------------------------
    # Embedding / head.
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        cfg = self.cfg
        x = F.embedding(tokens.long(), params["embed"]) * math.sqrt(cfg.d_model)
        return x.to(_dtype(cfg))

    def _head(self, params, x, serve: bool = False):
        cfg = self.cfg
        x = self._norm(x, params["final_norm"], serve)
        w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
        return x @ w

    def _rope(self, positions):
        return layers.rope_angles(positions, self.cfg.resolved_head_dim,
                                  self.cfg.rope_theta)

    # ------------------------------------------------------------------
    # Training loss.
    # ------------------------------------------------------------------

    def loss(self, params, batch) -> tuple[torch.Tensor, dict]:
        """batch: tokens [B,S] int, labels [B,S] int (-1 = masked), on the
        parameters' device."""
        tokens, labels = batch["tokens"], batch["labels"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        rope = self._rope(torch.arange(s, device=tokens.device))
        x, _ = self._run_stages(params, x, rope)
        logits = self._head(params, x).float()
        mask = labels >= 0
        safe = labels.clamp_min(0).long()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = (logz - ll) * mask
        denom = mask.sum().clamp_min(1)
        loss = nll.sum() / denom
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        total = loss + AUX_LOSS_COEF * aux
        return total, {"ce_loss": loss, "aux_loss": aux,
                       "tokens": denom.float()}

    # ------------------------------------------------------------------
    # KV cache.
    # ------------------------------------------------------------------

    def _cache_len(self, kind, max_len: int) -> int:
        w = kind["window"]
        return min(w, max_len) if w else max_len

    def _block_cache(self, kind, batch: int, max_len: int, device) -> dict:
        cfg = self.cfg
        cl = self._cache_len(kind, max_len)
        shape = (batch, cl, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "slot_pos": torch.full((cl,), -1, dtype=torch.int32,
                                   device=device),
        }

    def init_cache(self, batch: int, max_len: int, device="cuda") -> list:
        """An empty cache: every slot's position is -1."""
        return [{"blk00": self._block_cache(kind, batch, max_len, device)}
                for kind in self.kinds]

    # ------------------------------------------------------------------
    # Decode.
    # ------------------------------------------------------------------

    def _attn_decode(self, bp, cache, x, kind, pos: int, rope):
        """x: [B,1,d]; rope: cos/sin at ``pos``.  Writes the token into
        ``cache`` (in place) and returns ``(x, cache)``."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        h = self._norm(x, bp["norm1"], True)
        q, k, v = layers.qkv_proj(bp["attn"], h, cfg.num_heads,
                                  cfg.num_kv_heads, hd)
        cos, sin = rope
        q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
        kc, vc, spos = cache["k"], cache["v"], cache["slot_pos"]
        cl = kc.shape[1]
        # past the end of a full-attention cache the last slot is reused,
        # as the reference's clamp does
        slot = pos % cl if kind["window"] else min(pos, cl - 1)
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        spos[slot] = pos
        # mask: valid slot, causal, window
        valid = (spos >= 0) & (spos <= pos)
        if kind["window"]:
            valid &= spos > pos - kind["window"]
        o = self._masked_decode_attend(q, kc, vc, valid)
        return x + layers.out_proj(bp["attn"], o), cache

    @staticmethod
    def _masked_decode_attend(q, kc, vc, valid):
        """q: [B,1,Hq,D]; kc/vc: [B,CL,Hkv,D]; valid: [CL] bool."""
        b, _, hq, d = q.shape
        hkv = kc.shape[2]
        qg = q.reshape(b, 1, hkv, hq // hkv, d).float()
        qg = qg / math.sqrt(d)
        logits = torch.einsum("bskgd,btkd->bkgst", qg, kc.float())
        logits = torch.where(valid, logits, layers.NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m) * valid
        w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bkgst,btkd->bskgd", w, vc.float())
        return o.reshape(b, 1, hq, d).to(q.dtype)

    def _block_decode(self, bp, cache, x, kind, pos: int, rope):
        x, cache = self._attn_decode(bp, cache, x, kind, pos, rope)
        return self._ffn_half(bp, x, True), cache

    def decode_step(self, params, cache, tokens, pos: int):
        """tokens: [B,1] int; pos: the next position index.  Returns
        (logits [B,1,V], cache), the cache updated in place."""
        pos = int(pos)
        x = self._embed(params, tokens)
        rope = self._rope(torch.arange(pos, pos + 1, device=tokens.device))
        for kind, sp, sc in zip(self.kinds, params["stages"], cache):
            x, sc["blk00"] = self._block_decode(sp["blk00"], sc["blk00"], x,
                                                kind, pos, rope)
        return self._head(params, x, True), cache

    # ------------------------------------------------------------------
    # Prefill: run the full forward and materialize the cache.
    # ------------------------------------------------------------------

    def prefill(self, params, batch, max_len: int = 0):
        """batch: tokens [B,S].  Returns (last-token logits [B,V], cache
        primed with positions 0..S-1)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        max_len = max_len or s
        x = self._embed(params, tokens)
        rope = self._rope(torch.arange(s, device=tokens.device))
        x, states = self._run_stages(params, x, rope, collect_states=True)
        logits = self._head(params, x[:, -1:, :], True)[:, 0]
        cache = []
        for kind, st in zip(self.kinds, states):
            k, v = st["blk00"]["kv"]
            cl = self._cache_len(kind, max_len)
            kk, vv, spos = self._prime_cache_arrays(k, v, cl, s)
            cache.append({"blk00": {"k": kk, "v": vv, "slot_pos": spos}})
        return logits, cache

    def _prime_cache_arrays(self, k, v, cache_len: int, s: int):
        """Place the last ``cache_len`` positions of k/v [B,S,H,D] into the
        (ring) cache; k is already rope'd at its absolute position."""
        dev = k.device
        if s <= cache_len:
            pad = cache_len - s
            kk = F.pad(k, (0, 0, 0, 0, 0, pad))
            vv = F.pad(v, (0, 0, 0, 0, 0, pad))
            slots = torch.arange(cache_len, dtype=torch.int32, device=dev)
            spos = torch.where(slots < s, slots, -1)
        else:
            # ring buffer: keep the last cache_len positions
            positions = torch.arange(s - cache_len, s, device=dev)
            slots = positions % cache_len
            kk = torch.zeros((k.shape[0], cache_len) + k.shape[2:],
                             dtype=k.dtype, device=dev)
            vv = torch.zeros_like(kk)
            kk[:, slots] = k[:, -cache_len:]
            vv[:, slots] = v[:, -cache_len:]
            spos = torch.zeros((cache_len,), dtype=torch.int32, device=dev)
            spos[slots] = positions.to(torch.int32)
        return kk, vv, spos
