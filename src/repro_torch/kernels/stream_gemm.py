"""The out-of-core hot path through the CUDA kernels of ``csrc/stream_gemm.cu``.

Counterpart of :mod:`repro.kernels.stream_gemm`:

* :func:`stream_gemm` -- ``init + sign * (A @ B)`` in fp32, the K step of
  the out-of-core chain GEMM (the accumulator as ``init``) and the streamed
  mat-vec of the chi build and of CG.  On the card it has two routes, a
  fixed dispatch on n (:func:`route_for`): n > 32 runs as three TF32
  products on the tensor cores (``csrc/tf32x3.cuh``, ``block_matmul``'s
  design), n <= 32 on the bytes-bound skinny kernel.  Both need scratch
  (:func:`scratch_elems` floats), allocated per call unless the caller
  passes it;
* :func:`fused_panel_matvec` -- one richardson / chebyshev iteration over a
  P2 row panel: ``gy = chi + y - P y`` and the column sums and sum of
  squares of ``delta = chi - P y``.  On the card P y runs on the skinny
  route with :func:`skinny_plan`'s k split and a fused finish, so ``gy`` is
  bitwise ``stream_gemm(P, y, chi + y_panel, sign=-1)``; it allocates its
  :func:`matvec_scratch_elems` floats of scratch per call.

Operands may be fp32 or bf16 bit patterns carried as ``int16`` (the store's
bf16 codec ships uint16 bits; torch holds them as int16 views), widened
exactly in the kernel.  A CPU tensor takes the plain version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# kernel launches since the last reset (see kernels.reset_launch_counts)
gemm_launches = 0
tc_launches = 0  # stream_gemm launches on the tensor-core route
matvec_launches = 0

Q_MAX = 32  # widest right-hand side fused_panel_matvec takes
SKINNY_N_MAX = 32  # widest n the skinny route takes; wider goes to the tensor cores
_OPERAND_DTYPES = (torch.float32, torch.int16)
_TC_BK = 32  # the tensor-core route's K tile: its split parts' row stride is k rounded up to it
_SK_BM, _SK_KT = 64, 64  # the skinny route's rows per block and k per slab
# Blocks the skinny route aims to have on the card: several per SM of an
# H100 (132).  A constant, so the k split -- and with it the order each
# output is summed in -- depends on the shapes alone.
_SK_BLOCKS = 4 * 132
_FM_ROWS = 8  # rows per block of fused_panel_matvec's finish: one partial column sum each


def route_for(n: int) -> str:
    """The kernel route of a product with n output columns: "tc" or "skinny"."""
    return "skinny" if n <= SKINNY_N_MAX else "tc"


def skinny_plan(m: int, k: int) -> tuple[int, int]:
    """``(splits, slabs_per_split)``: the skinny route's k range as runs of
    64-deep slabs, enough of them that ~``_SK_BLOCKS`` blocks share the work."""
    slabs = max(-(-k // _SK_KT), 1)
    want = max(1, -(-_SK_BLOCKS // -(-m // _SK_BM)))
    per = -(-slabs // min(want, slabs))
    return -(-slabs // per), per


def scratch_elems(m: int, n: int, k: int, *, a_bits: bool = False, b_bits: bool = False) -> int:
    """fp32 scratch elements a (m, k) x (k, n) product needs on the card.

    Tensor-core route: the operands' TF32 parts, (2 m + 2 n) round_up(k, 32)
    with one part fewer per bits operand (exact in TF32).  Skinny route: the
    k splits' partial sums, splits x m x n.
    """
    if route_for(n) == "tc":
        kp = max(-(-k // _TC_BK), 1) * _TC_BK
        return ((1 if a_bits else 2) * m + (1 if b_bits else 2) * n) * kp
    return skinny_plan(m, k)[0] * m * n


def matvec_scratch_elems(ph: int, k: int, q: int) -> int:
    """fp32 scratch elements a (ph, k) panel times a (k, q) y needs on the card in
    :func:`fused_panel_matvec`: the k splits' partial sums, then per-block
    column sums and sums of squares."""
    return skinny_plan(ph, k)[0] * ph * q + -(-ph // _FM_ROWS) * (q + 1)


def _check_operand(name: str, x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got {tuple(x.shape)}")
    if x.dtype not in _OPERAND_DTYPES:
        raise TypeError(f"{name} must be float32 or int16 bf16 bits, got {x.dtype}")


def _check_cuda(name: str, tensors) -> None:
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: operands on different devices")
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")


def stream_gemm(
    a: torch.Tensor, b: torch.Tensor, init: torch.Tensor | None = None, *, sign: float = 1.0,
    out: torch.Tensor | None = None, scratch: torch.Tensor | None = None,
) -> torch.Tensor:
    """``init + sign * (A @ B)`` (init optional), (m, k) x (k, n) -> fp32 (m, n).

    ``out`` receives the result and is returned; it may be ``init`` itself
    (each output element reads its init value before writing it), which is
    how the chain's K step accumulates in place.  ``scratch``, a float32
    tensor of at least :func:`scratch_elems` elements on the operands'
    device, saves the card a per-call allocation (the plain version needs none).
    """
    global gemm_launches, tc_launches
    _build.refuse_grad("stream_gemm", a, b, init)
    _check_operand("stream_gemm: A", a)
    _check_operand("stream_gemm: B", b)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"stream_gemm: inner dims mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    n = b.shape[1]
    for name, t in (("init", init), ("out", out)):
        if t is not None and (tuple(t.shape) != (m, n) or t.dtype != torch.float32):
            raise ValueError(f"stream_gemm: {name} must be float32 {(m, n)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if sign not in (1.0, -1.0):
        raise ValueError(f"stream_gemm: sign selects add/subtract and must be +-1, got {sign}")
    a_bits, b_bits = a.dtype == torch.int16, b.dtype == torch.int16
    elems = scratch_elems(m, n, k, a_bits=a_bits, b_bits=b_bits)
    if scratch is not None and (scratch.dtype != torch.float32 or not scratch.is_contiguous()
                                or scratch.numel() < elems or scratch.device != a.device):
        raise ValueError(f"stream_gemm: scratch must be a contiguous float32 tensor of at least "
                         f"{elems} elements on {a.device}, got {scratch.dtype} "
                         f"{tuple(scratch.shape)} on {scratch.device}")
    tensors = tuple(t for t in (a, b, init, out) if t is not None)
    if all(t.device.type == "cpu" for t in tensors):
        c = ref.stream_gemm(a, b, init, sign=sign)
        return c if out is None else out.copy_(c)
    _check_cuda("stream_gemm", tensors)
    c = torch.empty((m, n), dtype=torch.float32, device=a.device) if out is None else out
    if c.numel() == 0:
        return c
    if scratch is None:
        scratch = torch.empty((elems,), dtype=torch.float32, device=a.device)
    lib = _build.library()
    args = (a.data_ptr(), int(a_bits), b.data_ptr(), int(b_bits),
            None if init is None else init.data_ptr(), int(sign < 0), c.data_ptr(), m, n, k)
    tail = (scratch.data_ptr(), scratch.numel(), _build.stream_handle(a))
    tc = route_for(n) == "tc"
    with _build.on_device(a):
        if tc:
            err = lib.rt_stream_gemm_tc(*args, *tail)
        else:
            err = lib.rt_stream_gemm_skinny(*args, *skinny_plan(m, k), *tail)
    _build.check(err, "stream_gemm")
    gemm_launches += 1
    tc_launches += tc
    return c


def fused_panel_matvec(
    p_panel: torch.Tensor, y: torch.Tensor, chi_panel: torch.Tensor, y_panel: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gy, colsum (1, q), sumsq (1, 1))`` for one (ph, K) panel of P2.

    ``y`` is (K, q); ``chi_panel`` / ``y_panel`` are the panel's (ph, q)
    rows of chi and y; all three fp32.
    """
    global matvec_launches
    _build.refuse_grad("fused_panel_matvec", p_panel, y, chi_panel, y_panel)
    _check_operand("fused_panel_matvec: P", p_panel)
    ph, kdim = p_panel.shape
    q = y.shape[1]
    if y.shape[0] != kdim:
        raise ValueError(f"fused_panel_matvec: inner dims mismatch {tuple(p_panel.shape)} @ "
                         f"{tuple(y.shape)}")
    if tuple(chi_panel.shape) != (ph, q) or tuple(y_panel.shape) != (ph, q):
        raise ValueError(f"fused_panel_matvec: chi/y panels must be {(ph, q)}, got "
                         f"{tuple(chi_panel.shape)}/{tuple(y_panel.shape)}")
    if any(t.dtype != torch.float32 for t in (y, chi_panel, y_panel)):
        raise TypeError("fused_panel_matvec: y, chi and y panels must be float32")
    tensors = (p_panel, y, chi_panel, y_panel)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.fused_panel_matvec(p_panel, y, chi_panel, y_panel)
    _check_cuda("fused_panel_matvec", tensors)
    if not 1 <= q <= Q_MAX:
        raise ValueError(f"fused_panel_matvec: q={q} outside 1..{Q_MAX}")
    dev = p_panel.device
    gy = torch.empty((ph, q), dtype=torch.float32, device=dev)
    cs = torch.empty((1, q), dtype=torch.float32, device=dev)
    ss = torch.empty((1, 1), dtype=torch.float32, device=dev)
    scratch = torch.empty((matvec_scratch_elems(ph, kdim, q),), dtype=torch.float32, device=dev)
    lib = _build.library()
    with _build.on_device(p_panel):
        err = lib.rt_fused_panel_matvec(
            p_panel.data_ptr(), int(p_panel.dtype == torch.int16), y.data_ptr(),
            chi_panel.data_ptr(), y_panel.data_ptr(), gy.data_ptr(), cs.data_ptr(),
            ss.data_ptr(), ph, kdim, q, *skinny_plan(ph, kdim), scratch.data_ptr(),
            scratch.numel(), _build.stream_handle(p_panel),
        )
    _build.check(err, "fused_panel_matvec")
    matvec_launches += 1
    return gy, cs, ss
