"""Causal / full attention through the hand-written CUDA kernel
(``csrc/flash_attention.cu``).

Counterpart of :mod:`repro.kernels.flash_attention`, with grouped-query
attention as one integer: q head ``h`` reads KV head ``h // groups``.  A CPU
(or ``meta``) tensor takes the plain version
(:func:`repro_torch.kernels.ref.flash_attention`, the materialized softmax);
a CUDA tensor launches a kernel or raises.

On the card the route is a fixed dispatch on dtype and head dim, not a
fallback:

* bf16 q/k/v with D in {64, 128} (the serve path's prefill) take the
  tensor-core kernel (``flash_kernel_wgmma``: TMA, ``wgmma``, P rounded to
  bf16 for the P V product); it needs 16-byte aligned operands and raises
  otherwise;
* fp32, or any other D up to 256, take the SIMT kernel (``flash_kernel``,
  FFMA in fp32): zamba2's shared block attends at D = 224.  A wider head
  raises.

``launches`` counts both routes; ``wgmma_launches`` the tensor-core route alone.

The kernel has no backward, nor has the JAX package's.  A gradient goes
through :class:`FlashAttentionFn`: the kernel forward, and a backward that
recomputes the plain chunked form with autograd in fp32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see kernels.reset_launch_counts)
wgmma_launches = 0  # of which on the tensor-core route

D_MAX = 256  # widest head the SIMT kernel takes (register accumulators per thread)
WGMMA_DIMS = (64, 128)  # head dims of the tensor-core route (bf16 only)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q, k, v, *, causal: bool = True, groups: int = 1) -> torch.Tensor:
    """(BHq, S, D) x (BHkv, T, D) x (BHkv, T, D) -> (BHq, S, D) in q's dtype.

    BHq = BHkv x ``groups``; q is scaled by 1/sqrt(D); under ``causal`` key
    ``j`` is visible to query ``i`` when ``i >= j``.
    """
    global launches, wgmma_launches
    _build.refuse_grad("flash_attention", q, k, v)
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention: want q (BHq,S,D), k = v (BHkv,T,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bhq, s, d = q.shape
    bhkv, t, dk = k.shape
    if dk != d:
        raise ValueError(f"flash_attention: head dims differ: q {d}, k/v {dk}")
    if groups < 1 or bhq != bhkv * groups:
        raise ValueError(f"flash_attention: BHq={bhq} is not BHkv={bhkv} x groups={groups}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must be one of fp32 / bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    if _build.plain(q):
        return ref.flash_attention(q, k, v, causal=causal, groups=groups)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: operands must be contiguous")
    if not 1 <= d <= D_MAX:
        raise ValueError(f"flash_attention: head dim d={d} outside 1..{D_MAX}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    lib = _build.library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    scale = 1.0 / (d**0.5)
    if q.dtype == torch.bfloat16 and d in WGMMA_DIMS:
        if any(p % 16 for p in ptrs):
            raise ValueError("flash_attention: the tensor-core route needs 16-byte aligned "
                             "q, k, v")
        with _build.on_device(q):
            err = lib.rt_flash_attention_wgmma(*ptrs, bhq, s, t, d, groups, int(causal), scale,
                                               _build.stream_handle(q))
        _build.check(err, "flash_attention (wgmma)")
        wgmma_launches += 1
    else:
        with _build.on_device(q):
            err = lib.rt_flash_attention(*ptrs, bhq, s, t, d, groups, int(causal), scale,
                                         int(q.dtype == torch.bfloat16), _build.stream_handle(q))
        _build.check(err, "flash_attention")
    launches += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a gradient, for the training forward.

    The JAX package trains through its plain chunked scan (``_chunked_flash``
    under ``jax.checkpoint``) and has no backward kernel.  So the forward
    launches the kernel and saves its inputs; the backward recomputes
    ``recompute(q, k, v, causal=, groups=)`` -- the model's chunked form on
    this layout -- with autograd in fp32, as ``jax.checkpoint`` recomputes,
    and returns the gradients in the inputs' dtypes.  On the tensor-core
    route the forward rounds P to bf16 for P V, so the gradient is the fp32
    form's, of a slightly different function.

    ``FlashAttentionFn.apply(q, k, v, causal, groups, recompute)``.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, groups: int, recompute):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.groups, ctx.recompute = causal, groups, recompute
        return flash_attention(q, k, v, causal=causal, groups=groups)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().to(torch.float32).requires_grad_(True) for t in (q, k, v)]
            out = ctx.recompute(*ins, causal=ctx.causal, groups=ctx.groups)
            gq, gk, gv = torch.autograd.grad(out, ins, grad.to(torch.float32))
        return gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype), None, None, None
