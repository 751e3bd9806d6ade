"""LM training demo on the PyTorch/CUDA port: a ~100M-parameter model, a few hundred steps.

The port of ``examples/train_lm.py``: the framework's full training path --
the deterministic data pipeline, the train step (the ``flash_attention``
kernel in the forward on the card), checkpointing, the watchdog -- on a
demo-sized granite-family dense decoder.  With ``--steps 300`` it learns the
synthetic data's deterministic next-token structure (the loss drops well
below ln(vocab)).  Checkpoints (parameters and AdamW moments, ~1.2 GB a
save) go to ``build/torch_train_lm`` and are removed at the end.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 60 [--device cpu]
"""

import argparse
import shutil
from pathlib import Path

from repro_torch.launch.train import train_loop
from repro_torch.models.common import ArchConfig

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_train_lm"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    # ~100M params: a granite-family dense decoder
    cfg = ArchConfig(
        name="demo-100m", family="dense", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=2048, vocab=8192, tie_embeddings=True, remat=False,
    )
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    _, _, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=str(CKPT_DIR),
        ckpt_every=max(args.steps // 4, 1), log_every=10, device=args.device,
    )
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps")
    return losses


if __name__ == "__main__":
    main()
