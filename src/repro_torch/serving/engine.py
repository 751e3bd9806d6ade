"""Batched serving engine: prefill a prompt batch, then decode token by token.

Port of :mod:`repro.serving.engine` on one device.  ``ServeEngine.generate``
keeps the JAX engine's contract: prompts (B, S) int32 [and, for an
encoder-decoder, frame embeddings (B, T, d_model)] in, the generated tokens
(B, max_new_tokens) int32 numpy out, greedy or by temperature.
Temperature sampling is the Gumbel-max draw ``jax.random.categorical``
makes, from a ``torch.Generator`` seeded with ``ServeConfig.seed``: the same
distribution, not the same bits.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import lm


@dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0


@dataclass
class ServeStats:
    """Host-clock times of the last ``generate`` (after a device sync)."""

    ttft_s: float = 0.0  # prefill and the first sample
    decode_s: float = 0.0  # the remaining decode steps and samples
    decode_steps: int = 0


class ServeEngine:
    """Batched request engine (greedy / temperature sampling) on one device.

    ``params`` are the model's weights (``lm.init_params`` or
    ``interop.lm_params_from_numpy``), on any device: the engine keeps a copy
    on its own device with the matrices cast to the compute dtype once (the
    model casts them at every call otherwise; the values are the same).  ``s_max`` bounds prompt plus new
    tokens; ``batch`` is accepted for parity with the JAX engine (any batch
    size runs).
    """

    def __init__(self, spec: lm.LMSpec, params, s_max: int, batch: int = 0,
                 cfg: ServeConfig = ServeConfig(), device="cuda"):
        self.spec, self.cfg, self.s_max, self.batch = spec, cfg, s_max, batch
        self.device = resolve_device(device)
        self.params = cm.cast_for_compute(params, spec.cfg.cdtype, self.device)
        self.stats = ServeStats()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, frames: np.ndarray | None = None) -> np.ndarray:
        """prompts (B, S_prompt) int [+ frames (B, T, d_model) float, the
        encoder's input] -> generated tokens (B, max_new) int32.  The cache
        holds the cross-attention's K/V over the T frames."""
        n_new = self.cfg.max_new_tokens
        if prompts.shape[1] + n_new - 1 > self.s_max:
            raise ValueError(f"prompt {prompts.shape[1]} + {n_new} new tokens exceed "
                             f"s_max={self.s_max}")
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=self.device)
        fr = None if frames is None else torch.as_tensor(np.asarray(frames), device=self.device)
        t0 = time.perf_counter()
        logits, cache = lm.prefill(self.spec, self.params, tokens, self.s_max, frames=fr)
        tok = self._sample(logits, gen)
        out = [tok]
        self._sync()
        t1 = time.perf_counter()
        # the JAX engine runs one more decode step whose logits it never samples
        for _ in range(n_new - 1):
            logits, cache = lm.decode_step(self.spec, self.params, tok, cache)
            tok = self._sample(logits, gen)
            out.append(tok)
        result = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        t2 = time.perf_counter()
        self.stats = ServeStats(ttft_s=t1 - t0, decode_s=t2 - t1, decode_steps=n_new - 1)
        return result

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        logits = logits.to(torch.float32)
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / self.cfg.temperature + gumbel, dim=-1)
