"""CAD anomaly scoring over a graph transition (paper Algorithm 4).

Port of :mod:`repro.core.cad`:

    dE  = |A_1 - A_2| (.) |D_1 - D_2|     (Hadamard)
    F_i = sum_j dE[i, j]                  (node anomaly scores)

The commute-distance matrices are never materialized: the ``cad_scores``
CUDA kernel rebuilds them tile by tile from the embeddings and row-reduces.
Either adjacency may be a snapshot handle: the scorer then streams matching
row panels of both endpoints, one kernel launch per panel.  On a device
grid each tile is one launch with its Z rows and columns, reduced over the
columns on the home device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.distmatrix import ITEM_9B, DistContext, context_of, grid_of, on_grid
from repro_torch.core.embedding import CommuteConfig, Embedding, commute_time_embedding
from repro_torch.core.tiles import MATRIX, REPLICATED, is_streamable, tile_map, tile_stream
from repro_torch.device import resolve_device
from repro_torch.kernels import cad_score as _cad
from repro_torch.obs import phase


def _cad_panel_body(r0: int, b1, b2, z1, z2, v1, v2) -> torch.Tensor:
    ph = b1.shape[0]
    return _cad.cad_scores_tile(
        b1.to(torch.float32).contiguous(), b2.to(torch.float32).contiguous(),
        z1[r0 : r0 + ph], z1, z2[r0 : r0 + ph], z2, v1, v2,
    )


def _cad_tile_body(tile, b1, b2, z1, z2, v1: float, v2: float) -> torch.Tensor:
    pr, pc = tile.block_shape
    ri, cj = slice(tile.row0, tile.row0 + pr), slice(tile.col0, tile.col0 + pc)
    return _cad.cad_scores_tile(b1.to(torch.float32).contiguous(),
                                b2.to(torch.float32).contiguous(),
                                z1[ri], z1[cj], z2[ri], z2[cj], v1, v2)


def node_anomaly_scores(
    a1, a2, e1: Embedding, e2: Embedding, *, prefetch_depth: int | None = None,
    ctx: DistContext | None = None,
) -> torch.Tensor:
    """F (n,): fused Alg. 4 lines 3-6.

    On a device grid (``ctx``, or the adjacencies DistMatrices) the scores
    come back on the home device; the volumes are read to the host once a
    call, not once a tile.
    """
    z1 = e1.z.to(torch.float32).contiguous()
    z2 = e2.z.to(torch.float32).contiguous()
    streamed = is_streamable(a1) or is_streamable(a2)
    ctx = grid_of(ctx, a1, a2)
    if streamed and ctx is not None and not ctx.is_trivial:
        raise NotImplementedError(f"node_anomaly_scores of snapshot handles: {ITEM_9B}")
    with phase("score", streamed=streamed) as sp:
        if streamed:
            scores = tile_stream(_cad_panel_body, a1, a2, device=z1.device,
                                 consts=(z1, z2, e1.vol, e2.vol), prefetch_depth=prefetch_depth)
        else:
            ctx = context_of(ctx, a1)
            scores = tile_map(ctx, _cad_tile_body, on_grid(ctx, a1), on_grid(ctx, a2), z1, z2,
                              float(e1.vol), float(e2.vol),
                              in_specs=(MATRIX, MATRIX) + (REPLICATED,) * 4, reduce="cols")
        sp.fence(scores)
    return scores


def top_anomalies(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, values) of the k largest scores; ties go to the lower id (``lax.top_k`` order)."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return idx[:k], vals[:k]


@dataclass
class CADResult:
    scores: torch.Tensor  # (n,) node anomaly scores
    top_idx: torch.Tensor  # (k,)
    top_val: torch.Tensor  # (k,)
    solve_reports: tuple = ()  # (left, right) endpoint SolveReports


def detect_anomalies(
    a1: torch.Tensor,
    a2: torch.Tensor,
    cfg: CommuteConfig | None = None,
    *,
    top_k: int = 10,
    device: str | torch.device = "cuda",
    ctx: DistContext | None = None,
) -> CADResult:
    """End-to-end CADDeLaG (Algorithm 4) for one graph transition, on ``device``.

    ``a1`` / ``a2`` are tensors or snapshot handles; on a device grid
    (``ctx``, or DistMatrices) tensors are cut into its tiles and the grid's
    home device takes the place of ``device``.
    """
    cfg = cfg or CommuteConfig()
    ctx = grid_of(ctx, a1, a2)
    if ctx is not None and not ctx.is_trivial:
        dev = ctx.home
        a1, a2 = on_grid(ctx, a1), on_grid(ctx, a2)
    else:
        dev = resolve_device(device)
        a1, a2 = (a if is_streamable(a) else a.to(dev) for a in (a1, a2))
    e1 = commute_time_embedding(a1, cfg, device=dev, ctx=ctx)
    e2 = commute_time_embedding(a2, cfg, device=dev, ctx=ctx)
    scores = node_anomaly_scores(a1, a2, e1, e2, prefetch_depth=cfg.prefetch_depth, ctx=ctx)
    idx, vals = top_anomalies(scores, top_k)
    for e in (e1, e2):  # the operators die here: retire any out-of-core scratch
        e.op.release_scratch()
    return CADResult(scores=scores, top_idx=idx, top_val=vals,
                     solve_reports=(e1.report, e2.report))
