"""Fault-tolerant LM training driver of the port, on one device.

Port of :mod:`repro.launch.train`: the train step (gradient accumulation,
clipping, AdamW or Adafactor as the config says), the deterministic
counter-hash data pipeline (restart-exact), atomic async checkpoints and
restore-on-start, failure injection (``--fail-at N`` exits with code 42;
the same command again resumes from the last checkpoint), and the straggler
watchdog.  ``--device`` picks the card (the default) or the CPU; a
checkpoint written on either resumes on the other.  ``--data`` and
``--model`` (a device mesh) are refused: the port has no mesh yet
(ROADMAP.md, item 9c).

  python -m repro_torch.launch.train --arch granite-3-2b --smoke --steps 20 \\
      --ckpt-dir /tmp/ckpt --ckpt-every 5 [--fail-at 12] --device cpu
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.data import DataConfig, host_batch
from repro_torch.device import resolve_device
from repro_torch.models import lm
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
               seed: int = 0, log_every: int = 1, device="cuda", history: list | None = None):
    """Returns (params, opt_state, losses).  Restarts from the latest
    checkpoint in ``ckpt_dir`` if there is one.  ``history``, a list, gets
    one dict a step: the metrics as floats and the step's seconds."""
    dev = resolve_device(device)
    spec = lm.build_spec(cfg)
    opt_cfg = OptConfig(name=cfg.optimizer, lr=1e-3, warmup_steps=5, total_steps=steps)
    step_fn = make_train_step(spec, opt_cfg, accum=accum, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
                      frames_dim=cfg.d_model if cfg.input_mode == "frames" else 0)

    params, opt_state = init_state(spec, opt_cfg, seed=seed, device=dev)
    start = 0
    if ckpt_dir and (last := latest_step(ckpt_dir)) is not None:
        state, _, start = restore(ckpt_dir, last, {"params": params, "opt": opt_state},
                                  device=dev)
        params, opt_state = state["params"], state["opt"]
        print(f"[train] restored step {start} from {ckpt_dir}")

    ckpt = AsyncCheckpointer()
    dog = StragglerWatchdog()
    inj = FailureInjector(fail_at_step=fail_at)
    losses = []
    for step in range(start, steps):
        inj.check(step)
        b = host_batch(dcfg, step)
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
            ckpt.save(ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                      extra={"loss": loss})
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
    ap.add_argument("--data", type=int, default=1, help="refused: the port has no mesh yet")
    ap.add_argument("--model", type=int, default=1, help="refused: the port has no mesh yet")
    args = ap.parse_args(argv)
    if args.data != 1 or args.model != 1:
        ap.error("--data / --model: the port trains on one device; a device mesh waits for "
                 "ROADMAP.md item 9c")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    try:
        _, _, losses = train_loop(
            cfg, steps=args.steps, batch=args.batch, seq=args.seq, accum=args.accum,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, fail_at=args.fail_at,
            device=args.device)
        if losses:
            print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    except InjectedFailure as e:
        print(f"[train] {e}; restart the same command to resume from checkpoint")
        raise SystemExit(42)


if __name__ == "__main__":
    main()
