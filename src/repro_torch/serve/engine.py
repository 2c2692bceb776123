"""Batched serving engine: pad-and-batch prefill, synchronous decode (port
of ``repro.serve.engine.Request`` and ``ServeEngine``).

The engine runs on one device.  The reference's GSPMD serving step
(``build_serve_step``, ``cache_pspecs``) and sequence-sharded decode wait
for the sharded state of ROADMAP item 9.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.nn.functional as F

from repro_torch.models.transformer import LM
from repro_torch.serve import sampling


@dataclasses.dataclass
class Request:
    prompt: torch.Tensor       # [S] int32
    max_new_tokens: int = 16


class ServeEngine:
    """Minimal batched engine: requests are grouped into one batch per
    call, left-padded with token 0 to align their last positions (there is
    no pad mask, as in the reference), prefilled once and decoded one token
    per step for the whole batch.

    ``step_ms`` holds the host milliseconds of the last ``generate``: the
    prefill first, then each decode step, each ending when its tokens reach
    the host (the one synchronisation per step)."""

    def __init__(self, model: LM, params, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0, device="cuda"):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.temperature = temperature
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step_ms: list[float] = []

    @torch.inference_mode()
    def generate(self, prompts: list[torch.Tensor],
                 max_new_tokens: int = 16) -> list[list[int]]:
        t0 = time.perf_counter()
        self.step_ms = []
        plen = max(int(p.shape[0]) for p in prompts)
        toks = torch.stack([F.pad(p.to(self.device, torch.int32),
                                  (plen - p.shape[0], 0)) for p in prompts])
        logits, cache = self.model.prefill(self.params, {"tokens": toks},
                                           max_len=self.max_len)
        tok = sampling.greedy(logits)
        steps = [tok[:, 0].tolist()]            # one host sync per step
        t0 = self._lap(t0)
        for t in range(max_new_tokens - 1):
            logits, cache = self.model.decode_step(self.params, cache, tok,
                                                   plen + t)
            lg = logits[:, 0]
            if self.temperature > 0:
                tok = sampling.temperature(lg, self.generator,
                                           self.temperature)
            else:
                tok = sampling.greedy(lg)
            steps.append(tok[:, 0].tolist())
            t0 = self._lap(t0)
        return [list(row) for row in zip(*steps)]

    def _lap(self, t0: float) -> float:
        t1 = time.perf_counter()
        self.step_ms.append((t1 - t0) * 1e3)
        return t1
