"""Fault-tolerant LM training driver of the port, on one device.

Port of :mod:`repro.launch.train`: the train step (gradient accumulation,
clipping, AdamW or Adafactor as the config says), the deterministic
counter-hash data pipeline (restart-exact), atomic async checkpoints and
restore-on-start, failure injection (``--fail-at N`` exits with code 42;
the same command again resumes from the last checkpoint), and the straggler
watchdog.  ``--device`` picks the card (the default) or the CPU; a
checkpoint written on either resumes on the other.  ``--data R --model C``
trains on an R x C device grid (``launch.mesh.make_device_grid``: one card
a tile, so ``--device cuda`` needs R x C cards; on the CPU every tile is on
the CPU) with the JAX step's rules, every family: the state per tile,
the batch generated per tile (``data.pipeline.global_batch_for``).  A
checkpoint is written whole, so one written on any grid (or by the JAX
package) resumes on any other: the elastic re-mesh.

  python -m repro_torch.launch.train --arch granite-3-2b --smoke --steps 20 \\
      --ckpt-dir build/ckpt --ckpt-every 5 [--fail-at 12] --device cpu [--data 2 --model 2]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.data import DataConfig, host_batch
from repro_torch.data.pipeline import global_batch_for
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_device_grid
from repro_torch.models import common as cm
from repro_torch.models import lm
from repro_torch.training import optim as opt_mod
from repro_torch.tree import tree_map
from repro_torch.training import train_step as ts
from repro_torch.training import (
    AsyncCheckpointer,
    FailureInjector,
    InjectedFailure,
    OptConfig,
    StepTimer,
    StragglerWatchdog,
    init_state,
    latest_step,
    make_train_step,
    restore,
)


def train_loop(cfg, *, steps: int, batch: int, seq: int, accum: int = 1,
               ckpt_dir: str | None = None, ckpt_every: int = 0, fail_at: int | None = None,
               seed: int = 0, log_every: int = 1, device="cuda", history: list | None = None,
               grid=None):
    """Returns (params, opt_state, losses).  Restarts from the latest
    checkpoint in ``ckpt_dir`` if there is one.  ``history``, a list, gets
    one dict a step: the metrics as floats and the step's seconds.

    With a ``grid`` larger than 1x1 (a ``DeviceGrid`` or ``DistContext``;
    ``device`` is then its home) the state is per-tile trees laid out by the
    train step's rules, and a checkpoint from any grid resumes onto this
    one."""
    g = cm.device_grid(grid) if grid is not None else None
    if g is not None:
        device = g.home
        g = None if g.is_trivial else g
    dev = resolve_device(device)
    spec = lm.build_spec(cfg)
    opt_cfg = OptConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=5, total_steps=steps)
    step_fn = make_train_step(spec, opt_cfg, accum=accum, device=dev, grid=g)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
                      frames_dim=cfg.d_model if cfg.input_mode == "frames" else 0)
    save_kw = {}
    if g is not None:
        pspecs, ospecs = ts.grid_specs(spec, opt_cfg, g)
        save_kw = {"specs": {"params": pspecs, "opt": ospecs}, "grid": g}
        bspec = cm.logical_to_spec(("batch", "seq"), ts.train_rules(spec, g))

    start = 0
    last = latest_step(ckpt_dir) if ckpt_dir else None
    if g is not None and last is not None:  # the whole state's template, on meta
        meta = ts._stacked_shapes(spec)
        tpl = {"params": meta, "opt": opt_mod.make_optimizer(opt_cfg)[0](meta)}
        state, _, start = restore(ckpt_dir, last, tpl, **save_kw)
        params, opt_state = [s["params"] for s in state], [s["opt"] for s in state]
        params = [tree_map(lambda t: t.requires_grad_(True), p) for p in params]
    else:
        params, opt_state = init_state(spec, opt_cfg, seed=seed, device=dev, grid=g)
        if last is not None:
            state, _, start = restore(ckpt_dir, last, {"params": params, "opt": opt_state},
                                      device=dev)
            params, opt_state = state["params"], state["opt"]
    if last is not None:
        print(f"[train] restored step {start} from {ckpt_dir}")

    ckpt = AsyncCheckpointer()
    dog = StragglerWatchdog()
    inj = FailureInjector(fail_at_step=fail_at)
    losses = []
    for step in range(start, steps):
        inj.check(step)
        b = host_batch(dcfg, step) if g is None else global_batch_for(dcfg, step, g, bspec)
        with StepTimer(dev) as t:
            params, opt_state, metrics = step_fn(params, opt_state, b)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        loss = metrics["loss"]
        losses.append(loss)
        if history is not None:
            history.append({**metrics, "seconds": t.dt})
        if dog.observe(step, t.dt):
            print(f"[watchdog] straggling step {step}: {t.dt:.3f}s vs EMA {dog.ema:.3f}s")
        if step % log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} grad_norm {metrics['grad_norm']:.4f} "
                  f"({t.dt * 1e3:.0f} ms)")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            state = ({"params": params, "opt": opt_state} if g is None else
                     [{"params": p, "opt": o} for p, o in zip(params, opt_state)])
            ckpt.save(ckpt_dir, step + 1, state, extra={"loss": loss}, **save_kw)
    ckpt.wait()
    return params, opt_state, losses


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="the reduced SMOKE config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--data", type=int, default=1, help="device grid data-axis size")
    ap.add_argument("--model", type=int, default=1, help="device grid model-axis size")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    grid = make_device_grid(args.data, args.model, args.device)
    try:
        _, _, losses = train_loop(
            cfg, steps=args.steps, batch=args.batch, seq=args.seq, accum=args.accum,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, fail_at=args.fail_at,
            device=args.device, grid=grid)
        if losses:
            print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    except InjectedFailure as e:
        print(f"[train] {e}; restart the same command to resume from checkpoint")
        raise SystemExit(42)


if __name__ == "__main__":
    main()
