"""C = A @ B through the hand-written tensor-core GEMM (``csrc/block_matmul.cu``).

Counterpart of :mod:`repro.kernels.block_matmul`.  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.block_matmul`); a CUDA tensor
launches the kernel or raises.

On the card the product runs on the tensor cores, a fixed dispatch on dtype:
fp32 operands as three TF32 products (each operand split into a TF32 high
part and the TF32 rounding of the rest, :func:`repro_torch.kernels.ref.split_tf32`;
``A_lo B_hi + A_hi B_lo + A_hi B_hi`` in one fp32 accumulator), bf16 operands
(exact in TF32) as one.  The split parts live in scratch allocated per call
(``2 (m + n) round_up(k, 32)`` floats for fp32, half that for bf16); when
``b is a`` the split pass reads the operand once.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0  # GEMM calls that launched since the last reset (see kernels.reset_launch_counts)

_DTYPES = (torch.float32, torch.bfloat16)
_BK = 32  # the kernel's K tile: the split parts' row stride is k rounded up to it


def _scratch_elems(m: int, n: int, k: int, parts: int) -> int:
    kp = -(-k // _BK) * _BK
    return parts * (m + n) * kp


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
    _build.refuse_grad("block_matmul", a, b)
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
    fp32 = a.dtype == torch.float32
    elems = _scratch_elems(m, n, k, 2 if fp32 else 1)
    scratch = torch.empty((elems,), dtype=torch.float32, device=a.device)
    lib = _build.library()
    fn = lib.rt_block_matmul_f32 if fp32 else lib.rt_block_matmul_bf16
    with _build.on_device(a):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, scratch.data_ptr(), elems,
                 int(b is a), _build.stream_handle(a))
    _build.check(err, "block_matmul")
    launches += 1
    return c if out_dtype == torch.float32 else c.to(out_dtype)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split pass alone: ``(hi, lo)`` of an fp32 matrix.

    A CPU tensor takes :func:`repro_torch.kernels.ref.split_tf32`.  On the
    card this is the check of the pass that every fp32 GEMM runs; it is not
    counted in ``launches``.
    """
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"split_tf32: want an fp32 matrix, got {x.dtype} {tuple(x.shape)}")
    _build.refuse_grad("split_tf32", x)
    if x.device.type == "cpu":
        return ref.split_tf32(x)
    if x.device.type != "cuda":
        raise ValueError(f"split_tf32: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("split_tf32: operand must be contiguous")
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return hi, lo
    lib = _build.library()
    with _build.on_device(x):
        err = lib.rt_split_tf32(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.shape[0],
                                x.shape[1], _build.stream_handle(x))
    _build.check(err, "split_tf32")
    return hi, lo
