"""Batched serving launcher of the port: prefill a prompt batch, decode N tokens.

Port of :mod:`repro.launch.serve` on one device, for every architecture of
``repro_torch.configs.ARCH_IDS``.  Weights are random, from the port's own
init (seed 0); prompts come from numpy ``default_rng(0)``, and for an
encoder-decoder (``input_mode == "frames"``) the encoder's frames
(B, prompt_len, d_model) right after them from the same generator, as the
JAX launcher draws them.  A model that
does not fit the card at its full depth (deepseek-67b, llama4) is served at
a reduced depth from code, with ``cfg.replace(n_layers=...)``.
``--data R --model C`` serves on an R x C device grid
(``launch.mesh.make_device_grid``: one card a tile, so ``--device cuda``
needs R x C cards; on the CPU every tile is on the CPU) under the JAX
engine's serve rules, every family (seamless's frames laid out by batch).

  python -m repro_torch.launch.serve --arch rwkv6-3b --batch 4 --prompt-len 1024 \\
      --max-new 32                                                  # on the card
  python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke --device cpu [--data 2 --model 2]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.collectives import lm_moves
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_device_grid
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServeEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="the reduced SMOKE config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--data", type=int, default=1, help="device grid data-axis size")
    ap.add_argument("--model", type=int, default=1, help="device grid model-axis size")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    grid = make_device_grid(args.data, args.model, args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    spec = lm.build_spec(cfg)
    params = lm.init_params(spec, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)
    frames = None
    if cfg.input_mode == "frames":
        frames = rng.normal(size=(args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
    eng = ServeEngine(spec, params, s_max=args.prompt_len + args.max_new, batch=args.batch,
                      cfg=ServeConfig(max_new_tokens=args.max_new, temperature=args.temperature),
                      device=dev, grid=grid)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    moved0 = lm_moves()["lm.serve"]
    out = eng.generate(prompts, frames=frames)
    moved = {k: v - moved0[k] for k, v in lm_moves()["lm.serve"].items() if k.endswith("_bytes")}
    st = eng.stats
    tput = args.batch * st.decode_steps / st.decode_s if st.decode_steps else float("nan")
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB" if dev.type == "cuda"
            else "not measured (CPU)")
    print(f"[serve] {cfg.name}{' (smoke)' if args.smoke else ''} on {dev}, grid "
          f"{args.data}x{args.model}: "
          f"{lm.param_count(params):,} parameters, batch {args.batch}, prompt "
          f"{args.prompt_len}, {args.max_new} new tokens")
    print(f"[serve] time to first token {st.ttft_s * 1e3:.1f} ms; decode "
          f"{st.decode_s / max(st.decode_steps, 1) * 1e3:.2f} ms/step, {tput:.1f} tok/s; "
          f"peak device memory {peak}")
    if not grid.is_trivial:
        print("[serve] moved between grid positions (bytes): "
              + ", ".join(f"{k.removesuffix('_bytes')} {v:.0f}" for k, v in moved.items()))
    print("[serve] first sequence:", out[0].tolist())


if __name__ == "__main__":
    main()
