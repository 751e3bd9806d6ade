"""RWKV6 WKV recurrence through the hand-written CUDA kernels (``csrc/wkv.cu``).

Counterpart of :mod:`repro.kernels.wkv`, with the initial state ``s0`` in
and the final state out, as :func:`repro_torch.models.rwkv6.wkv_chunked`
computes them (prefill hands the state to decode).  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.wkv`, the per-step
recurrence); a CUDA tensor launches the kernels or raises.  On the card a
call is a chunk-parallel scan of three launches over chunks of
:data:`CHUNK` rows (each chunk's state increment, the scan over chunks,
each chunk's outputs), with :func:`scratch_elems` floats of scratch; it
masks a ragged last chunk itself and takes the decay ratios pairwise, so
it has no chunk argument and no limit on the decay.

The kernels have no backward, nor has the JAX package's kernel.  A gradient
goes through :class:`WKVFn`: the kernel forward from a zero state, and a
backward that recomputes the plain chunked form with autograd in fp32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0  # wrapper calls that launched, since the last reset (see kernels.reset_launch_counts)

D_MAX = 64  # widest head the kernels take (a chunk's state is one shared-memory tile)
CHUNK = 64  # rows per chunk of the scan (WKV_L in csrc/wkv.cu)
_DTYPES = (torch.float32, torch.bfloat16)


def scratch_elems(bh: int, s: int, dk: int, dv: int) -> int:
    """fp32 scratch of one call on the card: each chunk's (dk, dv) state
    increment (then its incoming state) and its (dk,) decay."""
    return bh * -(-s // CHUNK) * (dk * dv + dk)


def wkv(r, k, v, lw, u, *, s0=None, return_state: bool = False):
    """y (BH, S, dv) in r's dtype [and s_final (BH, dk, dv) fp32 when ``return_state``].

    r/k (BH, S, dk) and v (BH, S, dv) fp32 or bf16, one dtype; lw (BH, S, dk)
    fp32 log decay <= 0; u (BH, dk) fp32 bonus; s0 (BH, dk, dv) fp32 or None.
    """
    global launches
    _build.refuse_grad("wkv", r, k, v, lw, u, s0)
    if r.ndim != 3 or k.shape != r.shape or lw.shape != r.shape:
        raise ValueError(f"wkv: r, k and lw must share one (BH, S, dk) shape, got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(lw.shape)}")
    bh, s, dk = r.shape
    if v.ndim != 3 or v.shape[:2] != (bh, s):
        raise ValueError(f"wkv: v must be {(bh, s)} x dv, got {tuple(v.shape)}")
    dv = v.shape[2]
    if tuple(u.shape) != (bh, dk):
        raise ValueError(f"wkv: u must be {(bh, dk)}, got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (bh, dk, dv):
        raise ValueError(f"wkv: s0 must be {(bh, dk, dv)}, got {tuple(s0.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv: r, k, v must be one of fp32 / bf16, got {r.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.dtype != torch.float32 for t in (lw, u) + (() if s0 is None else (s0,))):
        raise TypeError("wkv: lw, u and s0 must be float32")
    tensors = (r, k, v, lw, u) + (() if s0 is None else (s0,))
    if any(t.device != r.device for t in tensors):
        raise ValueError("wkv: operands on different devices")
    if r.device.type == "cpu":
        return ref.wkv(r, k, v, lw, u, s0=s0, return_state=return_state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv: unsupported device {r.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("wkv: operands must be contiguous")
    if not (1 <= dk <= D_MAX and 1 <= dv <= D_MAX):
        raise ValueError(f"wkv: head dims dk={dk}, dv={dv} outside 1..{D_MAX}")
    y = torch.empty((bh, s, dv), dtype=r.dtype, device=r.device)
    s_fin = torch.empty((bh, dk, dv), dtype=torch.float32, device=r.device)
    if bh > 0:
        scratch = torch.empty((scratch_elems(bh, s, dk, dv),), dtype=torch.float32,
                              device=r.device)
        lib = _build.library()
        with _build.on_device(r):
            err = lib.rt_wkv(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                             u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
                             s_fin.data_ptr(), scratch.data_ptr(), scratch.numel(), bh, s, dk,
                             dv, int(r.dtype == torch.bfloat16), _build.stream_handle(r))
        _build.check(err, "wkv")
        launches += 1
    return (y, s_fin) if return_state else y


class WKVFn(torch.autograd.Function):
    """:func:`wkv` from a zero state with a gradient, for the training forward.

    The JAX package trains through its plain chunked form (``wkv_chunked``
    in ``apply_rwkv_timemix``) and has no backward kernel.  So the forward
    launches the kernels and saves the inputs; the backward recomputes
    ``recompute(r, k, v, lw, u)`` -- the model's chunked form on this layout
    -- with autograd in fp32 and returns the gradients in the inputs' dtypes.
    ``u`` is (H, dk), the bonus of each of the H heads, shared by the
    BH / H sequences of the batch (row ``b * H + h`` reads ``u[h]``).

    ``WKVFn.apply(r, k, v, lw, u, recompute)`` -> y (BH, S, dv).
    """

    @staticmethod
    def forward(ctx, r, k, v, lw, u, recompute):
        ctx.save_for_backward(r, k, v, lw, u)
        ctx.recompute = recompute
        reps = r.shape[0] // u.shape[0]
        return wkv(r, k, v, lw, u.repeat(reps, 1))

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().to(torch.float32).requires_grad_(True) for t in saved]
            y = ctx.recompute(*ins)
            grads = torch.autograd.grad(y, ins, grad.to(torch.float32))
        return (*(g.to(t.dtype) for g, t in zip(grads, saved)), None)
