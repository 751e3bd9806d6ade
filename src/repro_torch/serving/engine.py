"""Batched serving engine: prefill a prompt batch, then decode token by token.

Port of :mod:`repro.serving.engine` on one device.  ``ServeEngine.generate``
keeps the JAX engine's contract: prompts (B, S) int32 [and, for an
encoder-decoder, frame embeddings (B, T, d_model)] in, the generated tokens
(B, max_new_tokens) int32 numpy out, greedy or by temperature.
Temperature sampling is the Gumbel-max draw ``jax.random.categorical``
makes, from a ``torch.Generator`` seeded with ``ServeConfig.seed``: the same
distribution, not the same bits.

On a device grid (``grid=``: every family) the engine holds the weights once, as per-tile trees laid out by the JAX engine's
decode rules: the arch's rules with ``moe_gathered`` and ``embed_p`` /
``embed_d`` whole (heads, d_ff and the vocab over ``model``, the cache's
positions over ``model``, the expert stacks over ``experts``' and
``expert_embed``'s axes), so decode moves tokens, not weights.  Prefill
runs under the JAX engine's prefill rules, which lack ``moe_gathered``
(:func:`prefill_rules`): an MoE layer takes the batch shards' branch with
its capacity per batch shard, as the JAX prefill does, and its tiles
gather the slices of the expert stacks that branch reads (counted).  So
does granite-moe's decode, whose experts are not sharded (the JAX
gathered path's fallback).  The dense layers keep the decode layout,
which gives them the same numbers.
Prompts and sampled tokens are laid out by ``("batch",)``, as the JAX
engine's ``_token_sharding``, an encoder-decoder's frames by ``("batch",
"seq", "embed")``; each step's logits are gathered whole on the
home device and sampled there with the one generator in the single-device
order, so a grid samples the tokens a single device samples from the same
logits.  Moves count under ``lm.serve``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import collectives as coll
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


def serve_rules(spec: lm.LMSpec, grid, rules=None) -> dict:
    """The JAX engine's decode rules on ``grid``: ``rules`` (by default
    ``multipod_rules`` on a pod grid, else ``DEFAULT_RULES``) with the arch's
    overrides, ``moe_gathered`` and every weight's d_model dim whole, the
    grid attached and moves counted under ``lm.serve``.  The weights are
    stored by these rules.  ``grid`` may also be a ``LogicalGrid`` (the dry
    run's): then only its axis sizes are attached."""
    g = cm.device_grid(grid) or grid
    rules = rules or (cm.multipod_rules() if "pod" in g.axis_names else dict(cm.DEFAULT_RULES))
    rules = {**cm.arch_rules(spec.cfg, rules), "moe_gathered": True, "embed_p": None,
             "embed_d": None}
    return {**cm.attach_axis_sizes(rules, g), "_path": "lm.serve"}


def prefill_rules(decode_rules: dict) -> dict:
    """The JAX engine's prefill rules beside :func:`serve_rules`' decode
    rules: without ``moe_gathered`` (the JAX ``make_prefill`` never adds it)."""
    return {k: v for k, v in decode_rules.items() if k != "moe_gathered"}


class ServeEngine:
    """Batched request engine (greedy / temperature sampling) on one device
    or on a device grid.

    ``params`` are the model's weights (``lm.init_params`` or
    ``interop.lm_params_from_numpy``), on any device: the engine keeps a copy
    on its own device with the matrices cast to the compute dtype once (the
    model casts them at every call otherwise; the values are the same).  ``s_max`` bounds prompt plus new
    tokens; ``batch`` is accepted for parity with the JAX engine (any batch
    size runs).  With a ``grid`` larger than 1x1 (a ``DeviceGrid`` or a
    ``DistContext``) the copy is per-tile trees laid out by
    :func:`serve_rules` (``rules`` replaces their base); ``device`` is then
    the grid's home device.  A 1x1 grid is the single-device engine on its
    device.
    """

    def __init__(self, spec: lm.LMSpec, params, s_max: int, batch: int = 0,
                 cfg: ServeConfig = ServeConfig(), device="cuda", *, grid=None, rules=None):
        self.spec, self.cfg, self.s_max, self.batch = spec, cfg, s_max, batch
        self.grid = self.rules = self.prefill_rules = None
        g = cm.device_grid(grid) if grid is not None else None
        if g is not None:
            device = g.home
            if not g.is_trivial:
                self.grid, self.rules = g, serve_rules(spec, g, rules)
                self.prefill_rules = prefill_rules(self.rules)
        self.device = resolve_device(device)
        cast = cm.cast_for_compute(params, spec.cfg.cdtype, self.device)
        if self.grid is None:
            self.params = cast
        else:
            tree = lm.param_dict(cast)
            self.specs = cm.sanitize_specs(lm.param_specs(spec, self.rules), tree, self.grid)
            self.tiles = cm.shard_tree(tree, self.specs, self.grid)
            del cast, tree
            self.params = lm.grid_view(spec, self.tiles, self.specs, self.grid, stacked=False)
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
        if fr is not None:
            fr = self._place(fr, ("batch", "seq", "embed"))
        t0 = time.perf_counter()
        logits, cache = lm.prefill(self.spec, self.params, self._place(tokens, ("batch", "seq")),
                                   self.s_max, frames=fr, rules=self.prefill_rules)
        tok = self._sample(self._whole(logits), gen)
        out = [tok]
        self._sync()
        t1 = time.perf_counter()
        # the JAX engine runs one more decode step whose logits it never samples
        for _ in range(n_new - 1):
            logits, cache = lm.decode_step(self.spec, self.params, self._place(tok, ("batch",)),
                                           cache, rules=self.rules)
            tok = self._sample(self._whole(logits), gen)
            out.append(tok)
        result = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        t2 = time.perf_counter()
        self.stats = ServeStats(ttft_s=t1 - t0, decode_s=t2 - t1, decode_steps=n_new - 1)
        return result

    def _place(self, tokens: torch.Tensor, axes: tuple):
        """Tokens (or frames) as the model takes them: whole without a grid,
        else cut into their tiles by ``axes`` (an input's placement: not
        counted)."""
        return tokens if self.grid is None else cm.GridRun(self.rules).place(tokens, axes)

    def _whole(self, logits) -> torch.Tensor:
        """The logits whole: as they are without a grid, else the per-tile
        (batch rows, whole vocab) logits gathered on the home device (the
        other rows' tiles move there: counted)."""
        g = self.grid
        if g is None:
            return logits
        ax = coll.entry_axes(logits.spec[0])
        rows = [logits[t] for t in range(g.n_tiles)
                if all(g.coords(t)[a] == 0 for a in g.axis_names if a not in ax)]
        coll._count("lm.serve", "gather", sum(coll._nbytes(r) for r in rows[1:]))
        return torch.cat([r.to(self.device) for r in rows], dim=0)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        logits = logits.to(torch.float32)
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / self.cfg.temperature + gumbel, dim=-1)
