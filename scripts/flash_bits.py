#!/usr/bin/env python3
"""The bits of ``flash_attention``'s output at ``chip_smoke.py`` phase 2's
forms, to hold two trees' kernels against each other on one card.

    python3 scripts/flash_bits.py [--src DIR]   # DIR: a tree's src/ (default: this tree's)

Inputs come from a fixed seed on the card at phase 2's shapes (qwen2-1.5b's
prefill: q (48, 1024, 128), k/v (8, 1024, 128), groups 6; bf16 causal,
non-causal, a ragged S = 1000, D = 64, fp32 causal; zamba2's D = 224), and
one JSON line prints each output's SHA-256.  No call passes ``q_offset``, so
a tree from before that argument runs the same calls: run this on a parent
commit's tree (``git archive`` under a gitignored directory) and on this one
in one call and compare the two lines.  ``chip_smoke.py`` phase 2 records
the same digests.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path


def digests(torch, fa) -> dict:
    """Form name -> SHA-256 of the output's bits (``fa``: a tree's
    ``repro_torch.kernels.flash_attention``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    grp, s, d = 6, 1024, 128
    q, k, v = randn(8 * grp, s, d), randn(8, s, d), randn(8, s, d)
    forms = {
        "bf16 causal": (q, k, v, True, grp),
        "bf16 non-causal": (q, k, v, False, grp),
        "bf16 causal ragged S=1000": tuple(t[:, :1000].contiguous() for t in (q, k, v))
        + (True, grp),
        "bf16 causal D=64": tuple(t[..., :64].contiguous() for t in (q, k, v)) + (True, grp),
        "fp32 causal": tuple(t.float() for t in (q, k, v)) + (True, grp),
        "bf16 causal D=224": (randn(32, s, 224), randn(32, s, 224), randn(32, s, 224), True, 1),
    }
    out = {}
    for name, (qq, kk, vv, causal, groups) in forms.items():
        y = fa.flash_attention(qq, kk, vv, causal=causal, groups=groups)
        bits = y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32)
        out[name] = hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("flash_bits: no card", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    from repro_torch.kernels import flash_attention as fa

    resolve_device("cuda")
    print(json.dumps({"src": args.src, "digests": digests(torch, fa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
