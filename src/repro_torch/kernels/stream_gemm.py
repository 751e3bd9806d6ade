"""The out-of-core hot path through the CUDA kernels of ``csrc/stream_gemm.cu``.

Counterpart of :mod:`repro.kernels.stream_gemm`:

* :func:`stream_gemm` -- ``init + sign * (A @ B)`` in fp32, the K step of
  the out-of-core chain GEMM (the accumulator as ``init``) and the streamed
  mat-vec of the chi build and of CG;
* :func:`fused_panel_matvec` -- one richardson / chebyshev iteration over a
  P2 row panel: ``gy = chi + y - P y`` and the column sums and sum of
  squares of ``delta = chi - P y``.

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
matvec_launches = 0

Q_MAX = 32  # widest right-hand side fused_panel_matvec takes
_OPERAND_DTYPES = (torch.float32, torch.int16)


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
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """``init + sign * (A @ B)`` (init optional), (m, k) x (k, n) -> fp32 (m, n).

    ``out`` receives the result and is returned; it may be ``init`` itself
    (each output element reads its init value before writing it), which is
    how the chain's K step accumulates in place.
    """
    global gemm_launches
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
    tensors = tuple(t for t in (a, b, init, out) if t is not None)
    if all(t.device.type == "cpu" for t in tensors):
        c = ref.stream_gemm(a, b, init, sign=sign)
        return c if out is None else out.copy_(c)
    _check_cuda("stream_gemm", tensors)
    c = torch.empty((m, n), dtype=torch.float32, device=a.device) if out is None else out
    if c.numel() == 0:
        return c
    lib = _build.library()
    err = lib.rt_stream_gemm(
        a.data_ptr(), int(a.dtype == torch.int16), b.data_ptr(), int(b.dtype == torch.int16),
        None if init is None else init.data_ptr(), int(sign < 0), c.data_ptr(), m, n, k,
        _build.stream_handle(a),
    )
    _build.check(err, "stream_gemm")
    gemm_launches += 1
    return c


def fused_panel_matvec(
    p_panel: torch.Tensor, y: torch.Tensor, chi_panel: torch.Tensor, y_panel: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gy, colsum (1, q), sumsq (1, 1))`` for one (ph, K) panel of P2.

    ``y`` is (K, q); ``chi_panel`` / ``y_panel`` are the panel's (ph, q)
    rows of chi and y; all three fp32.
    """
    global matvec_launches
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
    n_blocks = (ph + 7) // 8  # FM_ROWS rows per block in the kernel
    part_cs = torch.empty((n_blocks, q), dtype=torch.float32, device=dev)
    part_ss = torch.empty((n_blocks,), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.rt_fused_panel_matvec(
        p_panel.data_ptr(), int(p_panel.dtype == torch.int16), y.data_ptr(),
        chi_panel.data_ptr(), y_panel.data_ptr(), gy.data_ptr(), part_cs.data_ptr(),
        part_ss.data_ptr(), cs.data_ptr(), ss.data_ptr(), ph, kdim, q, _build.stream_handle(p_panel),
    )
    _build.check(err, "fused_panel_matvec")
    matvec_launches += 1
    return gy, cs, ss
