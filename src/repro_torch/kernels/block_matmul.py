"""C = A @ B through the hand-written fp32 CUDA GEMM (``csrc/block_matmul.cu``).

Counterpart of :mod:`repro.kernels.block_matmul`.  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.block_matmul`); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)

_DTYPES = (torch.float32, torch.bfloat16)


def block_matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """C = A @ B, (m, k) x (k, n), fp32 or bf16 in, fp32 accumulation."""
    global launches
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"block_matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(
            f"block_matmul: want two fp32 or two bf16 operands, got {a.dtype}, {b.dtype}"
        )
    if a.device != b.device:
        raise ValueError(f"block_matmul: operands on {a.device} and {b.device}")
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return ref.block_matmul(a, b, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"block_matmul: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("block_matmul: operands must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if c.numel() == 0 or k == 0:
        return c.zero_().to(out_dtype)
    lib = _build.library()
    fn = lib.rt_block_matmul_f32 if a.dtype == torch.float32 else lib.rt_block_matmul_bf16
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, _build.stream_handle(a))
    _build.check(err, "block_matmul")
    launches += 1
    return c if out_dtype == torch.float32 else c.to(out_dtype)
