"""Device resolution for every public entry point of the port.

Entry points take ``device=`` and default to ``"cuda"``.  Without a card a
CUDA request raises: the port never carries on silently on the CPU.  The CPU
is used only when the caller asks for it (the tests do).

fp32 means full fp32: the chain raises S~ to S~^(2^d), so TF32 rounding
would be amplified 2^d-fold.  Resolving a CUDA device switches TF32 off for
matmuls and cuDNN once.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises if CUDA is asked for but missing."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; want 'cuda' or 'cpu'")
    return dev


def synchronize(x=None) -> None:
    """Wait for queued device work (a no-op for CPU tensors / no card)."""
    if isinstance(x, torch.Tensor) and x.device.type != "cuda":
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
