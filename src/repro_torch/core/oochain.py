"""Out-of-core Peng-Spielman chain product: the squaring chain against
store-backed working matrices.

Port of :mod:`repro.core.oochain` (one device).  The recurrence

    T <- T @ T          P <- P @ T + P

runs entirely against a :class:`~repro_torch.store.TileStore` scratch: every
GEMM is a walk over output row panels, each a panel-accumulated sum

    C[I, :] = init[I, :] + sign * sum_K  L[I, K] @ R[K, :]

with L[I, K] sliced on the host from the left operand's row panel and R[K, :]
streamed host -> device one panel at a time.  Device residency per GEMM is
one accumulator panel, two staged right panels and one (panel x panel)
block: O(n * panel), never O(n^2).  The unary passes (S build, +I, the
D^{-1/2} sandwich, the Laplacian) stream one panel at a time.

With ``use_gemm_kernel`` each K step is one ``stream_gemm`` launch with the
accumulator as both ``init`` and ``out`` (in place), and panels ship in their
stored form (bf16 scratch as uint16 bits, widened in the kernel); the
kernel's scratch (the operands' TF32 parts, 127 MB at n=10512 with 1314-row
panels) is allocated once per GEMM and is not counted in
``stream.peak_live_bytes``, which counts panels; otherwise the K step is a plain
``acc +-= block @ right`` product, as the JAX package's ``_gemm_step`` is
plain XLA.  Each output panel comes back to the host (``.cpu()``, a sync)
to be written into the scratch; the ``oochain.d2h_seconds`` and
``oochain.store_write_seconds`` registry counters time those two steps.

Numerics: the panel accumulation orders the reductions differently from the
resident single GEMM, so the result is allclose, not bitwise, to the
resident build.  Working matrices are stored fp32 (or as the scratch codec
rounds them).
"""

from __future__ import annotations

import time
import uuid
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import laplacian as lap
from repro_torch.core.chain import ChainOperator
from repro_torch.core.tiles import is_streamable, stream_stats
from repro_torch.kernels import ref as kref
from repro_torch.kernels import stream_gemm as _sg
from repro_torch.obs import REGISTRY
from repro_torch.obs import trace as obs_trace

# ---------------------------------------------------------------------------
# panel programs (the row origin r0 is the panel's first global row)
# ---------------------------------------------------------------------------


def _s_panel_deflated(blk, r0, inv_sqrt, deg, vol):
    ph = blk.shape[0]
    s = blk.to(torch.float32) * inv_sqrt[r0 : r0 + ph, None] * inv_sqrt[None, :]
    u_r = torch.sqrt(torch.clamp(deg[r0 : r0 + ph], min=0.0) / vol)
    u_c = torch.sqrt(torch.clamp(deg, min=0.0) / vol)
    return s - u_r[:, None] * u_c[None, :]


def _s_panel_plain(blk, r0, inv_sqrt):
    ph = blk.shape[0]
    return blk.to(torch.float32) * inv_sqrt[r0 : r0 + ph, None] * inv_sqrt[None, :]


def _plus_eye_panel(blk, r0):
    out = blk.clone()
    out[:, r0 : r0 + blk.shape[0]].diagonal().add_(1.0)
    return out


def _l_panel(blk, r0, deg):
    ph = blk.shape[0]
    out = -blk.to(torch.float32)
    out[:, r0 : r0 + ph].diagonal().add_(deg[r0 : r0 + ph])
    return out


def _col_scale_panel(blk, v):
    return blk.to(torch.float32) * v[None, :]


def _gemm_step(acc, block, right, sign: float):
    """acc +-= block @ right in fp32, in place: one K term of a panel GEMM (plain)."""
    prod = block.to(torch.float32) @ right.to(torch.float32)
    return acc.sub_(prod) if sign < 0 else acc.add_(prod)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _write_panel(writer, r0: int, panel: torch.Tensor) -> None:
    """Bring an output panel to the host and write it into the scratch store.

    ``oochain.d2h_seconds`` includes the wait for the queued kernels that
    produce the panel (``.cpu()`` synchronises); ``oochain.store_write_seconds``
    is the tiling and (codec-encoded) write into the store.
    """
    t0 = time.perf_counter()
    host = panel.cpu().numpy()
    t1 = time.perf_counter()
    writer.put_row_panel(r0, host)
    REGISTRY.add_named({"oochain.d2h_seconds": t1 - t0,
                        "oochain.store_write_seconds": time.perf_counter() - t1})


def _auto_grid(n: int, quantum: int) -> int:
    """Default working-store grid: panels of >= 32 rows, >= 2 per side."""
    for g in (8, 4, 2):
        if n % g == 0 and (n // g) % quantum == 0 and n // g >= 32:
            return g
    for g in (16, 8, 4, 2, 1):
        if n % g == 0 and (n // g) % quantum == 0:
            return g
    raise ValueError(f"n={n} is not divisible by the panel quantum {quantum}")


# ---------------------------------------------------------------------------
# the out-of-core chain build
# ---------------------------------------------------------------------------


def chain_product_oocore(
    a,
    d_len: int,
    *,
    deflate: bool = True,
    fuse_l: bool = False,
    work=None,
    panel_rows: int | None = None,
    tile_codec: str = "raw",
    prefetch_depth: int | None = None,
    use_gemm_kernel: bool = False,
    device=None,
    level_sink: dict | None = None,
) -> ChainOperator:
    """Build the chain operator with store-backed working matrices.

    ``a`` is a device tensor or a snapshot handle (a handle keeps even the
    input off the card).  ``work`` is the scratch store: a
    :class:`~repro_torch.store.TileStore`, a directory, or ``None`` for host
    RAM.  ``panel_rows`` overrides the streaming unit, ``tile_codec`` the
    encoding of a scratch store this call creates, ``prefetch_depth`` the
    panel pipeline's staging depth.  Every scratch id carries a fresh nonce,
    so one scratch serves many builds; intermediates are removed as soon as
    the recurrence no longer needs them, and only P1 / P2 survive (retired
    by :meth:`ChainOperator.release_scratch`).  ``use_gemm_kernel`` routes
    the GEMM K steps through ``stream_gemm`` and rides on the operator, so
    its solves take the kernel path too.

    With a ``level_sink`` the levels the incremental delta path streams
    against survive the build as scratch snapshots: ``level_sink["t"]``
    holds T_0 .. T_{d-1} and ``level_sink["p"]`` P_1 .. P_{d-2}, owned by
    the caller from then on (``BaseChain.release``).  The last P and the
    implicit P_0 = I + T_0 are removed as usual.
    """
    from repro_torch.store import DEFAULT_PREFETCH_DEPTH, PanelPipeline, TileStore
    from repro_torch.store.pipeline import to_device

    if d_len < 1:
        raise ValueError("chain length d must be >= 1")
    dev = torch.device(device) if device is not None else a.device
    n = int(a.shape[0])
    quantum = int(a.panel_rows) if is_streamable(a) else 1
    if work is None or isinstance(work, (str, Path)):
        work = TileStore.create(work, n=n, grid=_auto_grid(n, quantum), codec=tile_codec)
    if work.n != n:
        raise ValueError(f"working store holds n={work.n}, adjacency is n={n}")
    ph = int(panel_rows or np.lcm(work.tile_rows, quantum))
    if n % ph or ph % work.tile_rows or ph % quantum:
        raise ValueError(
            f"panel_rows={ph} must divide n={n} and align to store tiles "
            f"({work.tile_rows}) and the source panels ({quantum})"
        )
    tag = f"w{uuid.uuid4().hex[:8]}."
    origins = list(range(0, n, ph))

    st = stream_stats()
    st.add(calls=1)
    deg = lap.degrees(a, device=dev, prefetch_depth=prefetch_depth)
    vol = lap.volume(deg)
    inv_sqrt = lap.inv_sqrt_degrees(deg)

    def put_panel(host: np.ndarray, decoded_nbytes: int | None = None) -> torch.Tensor:
        t, _ = to_device(host, dev)  # same stream as its consumer: no event needed
        nb = _nbytes(t)
        inc = {"panels": 1, "bytes_h2d": nb}
        if decoded_nbytes is not None and decoded_nbytes > nb:
            inc["bytes_h2d_saved"] = decoded_nbytes - nb  # stored-width put
        st.add(**inc)
        return t

    def stream(source, walk=None, *, on_device: bool, encoded: bool = False):
        """A prefetching pipeline over row panels of one operand."""
        return PanelPipeline(
            [source], walk if walk is not None else origins, ph, depth=prefetch_depth,
            device=dev if on_device else None, stats=st, encoded=encoded,
        )

    def live(pipe, source, blk) -> int:
        # Resident sources are sliced, not staged: count the slice itself.
        return pipe.device_live_bytes if is_streamable(source) else _nbytes(blk)

    def unary_pass(out_id: str, source, fn, *args):
        """Stream panels through a panel program into the store."""
        with obs_trace.span("oochain.unary", out=out_id), \
                work.writer(out_id) as w, stream(source, on_device=True) as pipe:
            for r0, (blk,) in pipe:
                out = fn(blk, r0, *args)
                st._note_live(live(pipe, source, blk) + _nbytes(out))
                _write_panel(w, r0, out)
        return work.snapshot(out_id)

    def oo_gemm(out_id: str, left_h, right_h, *, init: str = "zero", sign: float = 1.0,
                col_scale=None):
        """C[I, :] = init_I + sign * sum_K left[I, K] @ right[K, :] into the store.

        ``init``: "zero", "left" (C = left + ...; the P @ T + P fusion) or
        "left_colscale" (C = left * col_scale - ...; the fuse_l P2 build).
        The left row panel stays on the host; only its (ph, ph) K blocks,
        the streamed right panels and the accumulator reach the device.
        """
        nested = [k0 for _ in origins for k0 in origins]  # right walk, per row
        # one scratch for every K step of this GEMM, sized for fp32 operands
        scratch = (torch.empty((_sg.scratch_elems(ph, n, ph),), dtype=torch.float32, device=dev)
                   if use_gemm_kernel else None)
        with obs_trace.span("oochain.gemm", out=out_id, panels=len(origins)), \
                work.writer(out_id) as w, \
                stream(left_h, on_device=False, encoded=use_gemm_kernel) as lpipe, \
                stream(right_h, nested, on_device=True, encoded=use_gemm_kernel) as rpipe:
            right_iter = iter(rpipe)
            for r0, (left_host,) in lpipe:
                left_host = np.asarray(left_host)
                left_enc = left_host.dtype == np.uint16
                if init in ("left", "left_colscale"):
                    lp = put_panel(left_host, ph * n * 4 if left_enc else None)
                    acc = kref.decode_bits(lp)
                    if init == "left_colscale":
                        acc = _col_scale_panel(acc, col_scale)
                else:
                    acc = torch.zeros((ph, n), dtype=torch.float32, device=dev)
                for k0 in origins:
                    _, (right,) = next(right_iter)
                    block = put_panel(left_host[:, k0 : k0 + ph], ph * ph * 4 if left_enc else None)
                    if use_gemm_kernel:  # both accumulate in place
                        _sg.stream_gemm(block, right, acc, sign=sign, out=acc, scratch=scratch)
                        transient = 0
                    else:
                        _gemm_step(acc, block, right, sign)
                        transient = _nbytes(acc)  # the plain step's product
                    st._note_live(_nbytes(acc) + transient + _nbytes(block)
                                  + live(rpipe, right_h, right))
                _write_panel(w, r0, acc)
        return work.snapshot(out_id)

    # S (= T at level 0) and P0 = I + S in one pass over A.  Level ids use a
    # "lvl" infix so they never collide with the final P1 / P2.
    s_id, p_id = tag + "Tlvl0", tag + "Plvl0"
    with obs_trace.span("oochain.s_build", n=n, panels=len(origins)), \
            work.writer(s_id) as ws, work.writer(p_id) as wp, \
            stream(a, on_device=True) as apipe:
        for r0, (blk,) in apipe:
            if deflate:
                s_blk = _s_panel_deflated(blk, r0, inv_sqrt, deg, vol)
            else:
                s_blk = _s_panel_plain(blk, r0, inv_sqrt)
            p_blk = _plus_eye_panel(s_blk, r0)
            st._note_live(live(apipe, a, blk) + _nbytes(s_blk) + _nbytes(p_blk))
            _write_panel(ws, r0, s_blk)
            _write_panel(wp, r0, p_blk)
    t_h, p_h = work.snapshot(s_id), work.snapshot(p_id)

    retain = level_sink is not None
    t_levels, p_levels = [t_h], []
    for lvl in range(1, d_len):
        p_levels.append(p_h)
        t_new = oo_gemm(f"{tag}Tlvl{lvl}", t_h, t_h)
        p_new = oo_gemm(f"{tag}Plvl{lvl}", p_h, t_new, init="left")
        t_levels.append(t_new)
        if not retain:
            work.remove_snapshot(t_h.snap_id)
            work.remove_snapshot(p_h.snap_id)
        t_h, p_h = t_new, p_new

    # the P1 sandwich is the same row/col scaling as the undeflated S build
    p1_h = unary_pass(tag + "P1", p_h, _s_panel_plain, inv_sqrt)
    if fuse_l:
        p2_h = oo_gemm(tag + "P2", p1_h, a, init="left_colscale", sign=-1.0, col_scale=deg)
    else:
        l_h = unary_pass(tag + "L", a, _l_panel, deg)
        p2_h = oo_gemm(tag + "P2", p1_h, l_h)
        work.remove_snapshot(l_h.snap_id)
    work.remove_snapshot(p_h.snap_id)
    if retain:
        # T_0..T_{d-1} and P_1..P_{d-2} stay live for the delta path; the
        # last P (removed above) and the implicit P_0 are not needed.
        if p_levels:
            work.remove_snapshot(p_levels[0].snap_id)
        level_sink["t"] = t_levels
        level_sink["p"] = p_levels[1:]
    else:
        work.remove_snapshot(t_h.snap_id)

    # rho(S~^{2^d}) once at build: P2 is wrapped in a CachingHandle, so the
    # estimate costs one real scratch pass.
    from repro_torch.core.solvers.power import estimate_rho

    with obs_trace.span("oochain.estimate_rho", n=n):
        rho = estimate_rho(p2_h, device=dev, prefetch_depth=prefetch_depth)
    return ChainOperator(
        p1=p1_h, p2=p2_h, deg=deg, vol=vol, rho=rho,
        prefetch_depth=prefetch_depth or DEFAULT_PREFETCH_DEPTH,
        use_gemm_kernel=use_gemm_kernel,
    )
