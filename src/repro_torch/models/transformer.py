"""Dense decoder-only LM (port of the dense, unscanned path of
``repro.models.transformer.LM``).

The parameter tree has the reference's layout and path strings:
``{"embed", "stages": [{"blk00": {"norm1", "attn", "norm2", "mlp"}}, ...],
"final_norm"}`` with one stage per block (``scan_layers=False``).  With
``remat`` set, each block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``), which changes no numbers.

MoE, Mamba, xLSTM, encoder-decoder, scanned stacks and the KV caches are
not ported yet (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ParallelConfig
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

    def _attn_train(self, bp, x, kind, rope):
        cfg, par = self.cfg, self.parallel
        hd = cfg.resolved_head_dim
        h = layers.rms_norm(x, bp["norm1"], cfg.norm_eps)
        q, k, v = layers.qkv_proj(bp["attn"], h, cfg.num_heads,
                                  cfg.num_kv_heads, hd)
        cos, sin = rope
        q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
        o = layers.attention(q, k, v, causal=kind["causal"],
                             window=kind["window"], chunk=par.attn_chunk)
        return x + layers.out_proj(bp["attn"], o)

    def _ffn_half(self, bp, x):
        cfg = self.cfg
        h = layers.rms_norm(x, bp["norm2"], cfg.norm_eps)
        return x + layers.mlp_apply(bp["mlp"], h, cfg.act)

    def _block_train(self, bp, x, kind, cos, sin):
        x = self._attn_train(bp, x, kind, (cos, sin))
        return self._ffn_half(bp, x)

    def _run_stages(self, params, x, rope):
        remat = self.parallel.remat in ("block", "alternating") \
            and torch.is_grad_enabled()
        cos, sin = rope
        for kind, sp in zip(self.kinds, params["stages"]):
            bp = sp["blk00"]
            if remat:
                x = checkpoint(self._block_train, bp, x, kind, cos, sin,
                               use_reentrant=False)
            else:
                x = self._block_train(bp, x, kind, cos, sin)
        return x

    # ------------------------------------------------------------------
    # Embedding / head.
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        cfg = self.cfg
        x = F.embedding(tokens.long(), params["embed"]) * math.sqrt(cfg.d_model)
        return x.to(_dtype(cfg))

    def _head(self, params, x):
        cfg = self.cfg
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
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
        x = self._run_stages(params, x, rope)
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
