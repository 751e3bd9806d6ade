"""Commute-time embedding (paper Algorithm 3, CommuteTimeEmbedding).

Port of :mod:`repro.core.embedding`.  For j = 1..k_RP,
y_j = B^T W^{1/2} q_j is the edge-space Rademacher projection (the
``edge_projection`` CUDA kernel regenerates q from the counter hash and
reads only A); the chain solve gives z_j with L z_j = y_j, and

    c(i, j) ~= V_G * || Z_i - Z_j ||^2.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.chain import ChainOperator, chain_product
from repro_torch.core.distmatrix import DistContext, context_of, grid_of, grid_or_none, on_grid
from repro_torch.core.solvers import SolveReport, SolverSpec, solve
from repro_torch.core.tiles import MATRIX, REPLICATED, is_streamable, tile_map, tile_stream
from repro_torch.device import resolve_device
from repro_torch.kernels import edge_projection as _ep
from repro_torch.obs import REGISTRY, phase


@dataclass(frozen=True)
class CommuteConfig:
    """Accuracy knobs, named as in the paper (eps_RP, d, q), plus the solver's."""

    eps_rp: float = 1e-3
    d: int = 6  # inverse-chain length
    q: int = 10  # Richardson iterations
    seed: int = 0
    schedule: str = "cannon"  # the chain GEMMs' tile program on a device grid (1x1: one call)
    dtype: torch.dtype = torch.float32
    deflate: bool = True
    fuse_l: bool = False
    k_override: int | None = None  # force the embedding width (tests/ablations)
    # Out-of-core chain: S/T/P/P1/P2 spill through a TileStore scratch, so the
    # chain build and the solve hold a few row panels on the card, not n^2.
    oocore: bool = False
    oocore_dir: str | None = None  # scratch dir (or a TileStore); None = host-RAM scratch
    oocore_panel_rows: int | None = None  # override the streaming unit
    # Panel I/O: staging depth of the prefetch thread, scratch tile codec
    # (raw / bf16 / zstd), and solver iterations per store read of P2.
    prefetch_depth: int = 2
    tile_codec: str = "raw"
    solver_batch: int = 1
    # stream_gemm / fused_panel_matvec kernels for the out-of-core GEMMs and
    # the streamed solve (panels ship in stored form).
    use_gemm_kernel: bool = False
    solver: str = "richardson"  # "richardson" | "chebyshev" | "cg"
    solver_tol: float | None = None
    solver_max_iters: int | None = None
    delta: float | None = None
    warm_start: bool = False  # seed sequence solves with the previous solution
    # Incremental delta-chain updates (repro_torch.core.delta_chain): on a
    # slowly drifting transition, skip the O(n^3) chain rebuild -- compress
    # the change in S to a rank-`delta_rank` factorisation, propagate it
    # through the squaring recurrence as skinny passes against the retained
    # base chain (O(n^2 r) per level), and attach the result to the operator
    # as a low-rank correction every solve applies.  `delta_budget` is the
    # drift gate: the sketched relative drift ||dS|| / ||S|| (always measured
    # against the last full rebuild, so corrections never compound) above
    # which the detector falls back to a full rebuild that becomes the new base.
    incremental_chain: bool = False
    delta_rank: int = 4
    delta_budget: float = 0.1

    def k_rp(self, n: int) -> int:
        if self.k_override is not None:
            return int(self.k_override)
        return max(1, math.ceil(math.log(n / self.eps_rp)))

    def solver_spec(self) -> SolverSpec:
        return SolverSpec(
            method=self.solver,
            tolerance=self.solver_tol,
            max_iters=self.solver_max_iters,
            delta=self.delta,
        )


def _edge_projection_body(tile, blk: torch.Tensor, seed: int, k: int) -> torch.Tensor:
    return _ep.edge_projection(blk.to(torch.float32).contiguous(), seed=seed, k=k,
                               row0=tile.row0, col0=tile.col0)


def edge_projection(a, seed: int, k: int, *, device=None, prefetch_depth: int | None = None,
                    ctx: DistContext | None = None) -> torch.Tensor:
    """Y = B^T W^{1/2} Q / sqrt(k) for k Rademacher columns, (n, k).

    Each tile of ``a``'s grid (``ctx``, ``a``'s own if a DistMatrix, else the
    whole matrix) is one launch at the tile's global rows and columns, and
    the column partials are summed in order on the home device, where Y
    lives.  ``a`` may be a snapshot handle: its row panels then stream onto
    ``device``, or onto the tiles of ``ctx``, one launch per panel tile at
    its (row0, col0).
    """
    specs = (MATRIX, REPLICATED, REPLICATED)
    if is_streamable(a):
        return tile_stream(_edge_projection_body, a, seed, k, ctx=grid_or_none(ctx),
                           device=device, in_specs=specs, reduce="cols",
                           prefetch_depth=prefetch_depth)
    ctx = context_of(ctx, a)
    return tile_map(ctx, _edge_projection_body, on_grid(ctx, a), seed, k, in_specs=specs,
                    reduce="cols")


@dataclass
class Embedding:
    z: torch.Tensor  # (n, k)
    vol: torch.Tensor  # 0-dim V_G
    op: ChainOperator | None = None
    report: SolveReport | None = None


def commute_time_embedding(
    a: torch.Tensor,
    cfg: CommuteConfig,
    *,
    op: ChainOperator | None = None,
    warm_from: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
    ctx: DistContext | None = None,
) -> Embedding:
    """Z (n, k_RP) commute-time embedding of ``a`` (Algorithm 3), on ``device``.

    ``a`` is a tensor or a snapshot handle; a handle's row panels stream
    onto the device.  ``warm_from`` is a previous embedding's ``z``: the
    solver starts from it instead of the cold start.  A shape mismatch
    warns, is counted in ``solve.warm_skipped`` and solves cold.

    On a device grid (``ctx``, or ``a`` a DistMatrix) the chain and the
    edge projection run tile by tile with ``cfg.schedule`` (a handle's
    panels streamed onto the tiles, the out-of-core chain's panel GEMMs tile
    by tile); the solve and Z stay on the grid's home device, which takes
    the place of ``device``.
    """
    ctx = grid_of(ctx, a)
    dev = resolve_device(device if ctx is None else ctx.home)
    ctx = grid_or_none(ctx)
    if ctx is not None:
        a = on_grid(ctx, a)
    else:
        if not is_streamable(a):
            a = a.to(dev)
    n = int(a.shape[0])
    k = cfg.k_rp(n)
    if op is None:
        with phase("chain", n=n, d=cfg.d, oocore=cfg.oocore) as sp:
            op = chain_product(
                a, cfg.d, schedule=cfg.schedule, dtype=cfg.dtype,
                deflate=cfg.deflate, fuse_l=cfg.fuse_l, oocore=cfg.oocore,
                oocore_work=cfg.oocore_dir, oocore_panel_rows=cfg.oocore_panel_rows,
                tile_codec=cfg.tile_codec, prefetch_depth=cfg.prefetch_depth,
                use_gemm_kernel=cfg.use_gemm_kernel, device=dev, ctx=ctx,
            )
            sp.fence(op.vol)
    with phase("ingest", n=n, k=k) as sp:
        y = edge_projection(a, cfg.seed, k, device=dev, prefetch_depth=cfg.prefetch_depth,
                            ctx=ctx)
        sp.fence(y)
    y0 = None
    if warm_from is not None:
        if tuple(warm_from.shape) == (n, k):
            y0 = warm_from
        else:
            REGISTRY.inc("solve.warm_skipped")
            warnings.warn(
                f"warm_from shape {tuple(warm_from.shape)} does not match the "
                f"expected ({n}, {k}); solving cold (counted in solve.warm_skipped)",
                RuntimeWarning,
                stacklevel=2,
            )
    with phase("solve", n=n, k=k, method=cfg.solver, warm=y0 is not None) as sp:
        z, report = solve(
            op, y, cfg.solver_spec(), fixed_q=cfg.q, deflate=cfg.deflate,
            solver_batch=cfg.solver_batch, prefetch_depth=cfg.prefetch_depth, y0=y0,
        )
        sp.fence(z)
    return Embedding(z=z, vol=op.vol, op=op, report=report)


def validate_node_indices(name: str, idx, n: int) -> None:
    """Raise ``IndexError`` naming the first index of ``idx`` outside ``[0, n)``."""
    arr = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    if arr.size == 0:
        return
    bad = (arr < 0) | (arr >= n)
    if bad.any():
        first = int(arr[bad][0] if arr.ndim else arr)
        raise IndexError(
            f"{name} index {first} is out of range for n={n} (valid node ids are 0..n-1)"
        )


def commute_distance_block(emb: Embedding, rows, cols) -> torch.Tensor:
    """c(i, j) = V_G ||Z_i - Z_j||^2 for an index block."""
    n = int(emb.z.shape[0])
    validate_node_indices("rows", rows, n)
    validate_node_indices("cols", cols, n)
    dev = emb.z.device
    zi = emb.z[torch.as_tensor(rows, device=dev)].to(torch.float32)
    zj = emb.z[torch.as_tensor(cols, device=dev)].to(torch.float32)
    sq_i = torch.sum(zi * zi, dim=-1)
    sq_j = torch.sum(zj * zj, dim=-1)
    return emb.vol * (sq_i[:, None] + sq_j[None, :] - 2.0 * (zi @ zj.T))


def exact_commute_distances(a) -> np.ndarray:
    """O(n^3) eigendecomposition oracle in float64 numpy (tests / baselines)."""
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a = a.astype(np.float64)
    deg = a.sum(1)
    pinv = np.linalg.pinv(np.diag(deg) - a, rcond=1e-12)
    di = np.diag(pinv)
    return deg.sum() * (di[:, None] + di[None, :] - 2.0 * pinv)
