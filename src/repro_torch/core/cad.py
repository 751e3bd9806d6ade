"""CAD anomaly scoring over a graph transition (paper Algorithm 4).

Port of :mod:`repro.core.cad`:

    dE  = |A_1 - A_2| (.) |D_1 - D_2|     (Hadamard)
    F_i = sum_j dE[i, j]                  (node anomaly scores)

The commute-distance matrices are never materialized: the ``cad_scores``
CUDA kernel rebuilds them tile by tile from the embeddings and row-reduces.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.embedding import CommuteConfig, Embedding, commute_time_embedding
from repro_torch.device import resolve_device
from repro_torch.kernels import cad_score as _cad
from repro_torch.obs import phase


def node_anomaly_scores(
    a1: torch.Tensor, a2: torch.Tensor, e1: Embedding, e2: Embedding
) -> torch.Tensor:
    """F (n,): fused Alg. 4 lines 3-6."""
    with phase("score") as sp:
        scores = _cad.cad_scores(
            a1.to(torch.float32).contiguous(), a2.to(torch.float32).contiguous(),
            e1.z.to(torch.float32).contiguous(), e2.z.to(torch.float32).contiguous(),
            e1.vol, e2.vol,
        )
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
) -> CADResult:
    """End-to-end CADDeLaG (Algorithm 4) for one graph transition, on ``device``."""
    cfg = cfg or CommuteConfig()
    dev = resolve_device(device)
    a1, a2 = a1.to(dev), a2.to(dev)
    e1 = commute_time_embedding(a1, cfg, device=dev)
    e2 = commute_time_embedding(a2, cfg, device=dev)
    scores = node_anomaly_scores(a1, a2, e1, e2)
    idx, vals = top_anomalies(scores, top_k)
    return CADResult(scores=scores, top_idx=idx, top_val=vals,
                     solve_reports=(e1.report, e2.report))
