"""Query read path: top-k / nearest-neighbor / pairwise reads from a
persisted embedding artifact.

Port of :mod:`repro.core.query`.  Once an
:class:`~repro_torch.store.EmbeddingStore` holds a committed (Z, vol, deg)
sketch, a read is O(n k_RP): Z streams in row panels through
:class:`~repro_torch.store.PanelPipeline` (stored form: a bf16 artifact
crosses to the card as its bits and widens in the kernel), and the
``panel_topk_update`` CUDA kernel merges each panel into the running
(q, topk) state, through one :class:`~repro_torch.kernels.emb_query.PanelTopk`
per query (arguments checked once, one launch per panel).  No n-long score
vector and no n x n block is built; the card holds two panels plus the state.

* :func:`top_anomalies_from_store` -- the k nodes farthest from the volume
  centroid ``zbar`` (same ranking as mean commute distance to all nodes);
  ``corrected=True`` scores the von Luxburg amplified distance
  ``C/vol - 1/deg_i - 1/deg_j`` (arXiv 1003.1266).
* :func:`nearest_neighbors` -- the k closest nodes to one node, itself
  excluded in the kernel.
* :func:`commute_block` -- the distance block of a few node pairs, on the host.

Every query runs under a ``phase("query")`` span and adds to the
``query.{calls,panels,bytes_read,latency_ms}`` registry counters.
``caddelag-query-torch`` (:func:`main`) is the CLI over a store directory.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.embedding import validate_node_indices
from repro_torch.core.tiles import stream_stats
from repro_torch.device import resolve_device
from repro_torch.kernels.emb_query import PanelTopk
from repro_torch.obs import REGISTRY, phase
from repro_torch.store.pipeline import PanelPipeline

__all__ = [
    "QueryResult",
    "commute_block",
    "main",
    "nearest_neighbors",
    "rank_auc",
    "top_anomalies_from_store",
]


@dataclass
class QueryResult:
    """One answered query plus its cost telemetry."""

    idx: np.ndarray  # (k,) node ids, best first (-1 in unfilled slots)
    val: np.ndarray  # (k,) scores (raw commute or corrected, see `corrected`)
    emb_id: str
    corrected: bool
    panels: int  # Z row panels streamed
    bytes_read: int  # backing-tier bytes served (pre-decode)
    latency_ms: float


def _resolve_handle(store, emb_id: str | None):
    """An :class:`EmbeddingHandle` from a store or a handle (duck-typed:
    handles carry their ``emb_id``)."""
    if hasattr(store, "emb_id"):
        return store
    return store.latest() if emb_id is None else store.embedding(emb_id)


def _streamed_topk(
    handle,
    zq: np.ndarray,
    inv_deg_q: np.ndarray,
    *,
    topk: int,
    corrected: bool,
    largest: bool,
    exclude: np.ndarray | None = None,
    prefetch_depth: int | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray, int]:
    """One pass over the artifact's Z panels, one kernel call per panel;
    returns (vals, ids, n_panels)."""
    dev = resolve_device(device)
    n, _ = handle.shape
    pr = handle.panel_rows
    topk = min(int(topk), n)
    zq_t = torch.from_numpy(np.array(zq, np.float32)).to(dev)
    q = zq_t.shape[0]
    idq = torch.from_numpy(np.array(inv_deg_q, np.float32).reshape(q, 1)).to(dev)
    inv_deg = torch.from_numpy(handle.inv_deg().reshape(1, n)).to(dev)
    ex = np.full((q, 1), -1, np.int32) if exclude is None else np.asarray(exclude, np.int32)
    ex = torch.from_numpy(ex.reshape(q, 1).copy()).to(dev)
    merger = PanelTopk(zq_t, idq, inv_deg, ex, handle.vol, topk=topk, panel_rows=pr,
                       corrected=corrected, largest=largest)
    n_panels = 0
    with PanelPipeline([handle], range(0, n, pr), pr, depth=prefetch_depth, device=dev,
                       stats=stream_stats(), encoded=True) as pipe:
        for row0, (zp,) in pipe:
            merger.update(zp, row0)
            n_panels += 1
    vals, idx = merger.result()
    return vals.cpu().numpy(), idx.cpu().numpy(), n_panels


def _run_query(kind: str, handle, fn, **span_args):
    """Shared telemetry: span, counters, latency (host clock around work
    that ends in the state's copy back to the host)."""
    t0 = time.perf_counter()
    m0 = REGISTRY.snapshot()
    with phase("query", kind=kind, emb_id=handle.emb_id, **span_args):
        vals, ids, n_panels = fn()
    dt_ms = (time.perf_counter() - t0) * 1e3
    bytes_read = int(REGISTRY.delta(m0).get("stream.bytes_read", 0.0))
    REGISTRY.add_named({
        "query.calls": 1.0,
        "query.panels": float(n_panels),
        "query.bytes_read": float(bytes_read),
        "query.latency_ms": dt_ms,
    })
    return vals, ids, n_panels, bytes_read, dt_ms


def top_anomalies_from_store(
    store,
    k: int = 10,
    *,
    emb_id: str | None = None,
    corrected: bool = False,
    prefetch_depth: int | None = None,
    device: str | torch.device = "cuda",
) -> QueryResult:
    """The k most anomalous nodes of one committed embedding artifact.

    Scores each node by ``vol * ||z_j - zbar||^2`` (``zbar`` persisted with
    the artifact), or with ``corrected=True`` by
    ``||z_j - zbar||^2 - mean(1/deg) - 1/deg_j``.  ``store`` is an
    :class:`~repro_torch.store.EmbeddingStore` (serving ``emb_id``, default
    latest) or an ``EmbeddingHandle``.
    """
    handle = _resolve_handle(store, emb_id)
    zq = handle.zbar.reshape(1, -1)
    inv_q = np.asarray([handle.inv_deg().mean()], np.float32)

    def run():
        return _streamed_topk(handle, zq, inv_q, topk=k, corrected=corrected, largest=True,
                              prefetch_depth=prefetch_depth, device=device)

    vals, ids, n_panels, bytes_read, dt_ms = _run_query(
        "top_anomalies", handle, run, corrected=corrected, k=k)
    return QueryResult(idx=ids[0], val=vals[0], emb_id=handle.emb_id, corrected=corrected,
                       panels=n_panels, bytes_read=bytes_read, latency_ms=dt_ms)


def nearest_neighbors(
    store,
    node: int,
    k: int = 10,
    *,
    emb_id: str | None = None,
    corrected: bool = False,
    prefetch_depth: int | None = None,
    device: str | torch.device = "cuda",
) -> QueryResult:
    """The k nearest (smallest commute distance) neighbors of ``node``,
    itself excluded in the kernel.  Same streaming as
    :func:`top_anomalies_from_store`."""
    handle = _resolve_handle(store, emb_id)
    n = handle.shape[0]
    validate_node_indices("node", node, n)
    zq = handle.read_rows([int(node)])
    inv_q = handle.inv_deg()[[int(node)]]
    exclude = np.asarray([int(node)], np.int32)

    def run():
        return _streamed_topk(handle, zq, inv_q, topk=min(k, n - 1), corrected=corrected,
                              largest=False, exclude=exclude, prefetch_depth=prefetch_depth,
                              device=device)

    vals, ids, n_panels, bytes_read, dt_ms = _run_query(
        "nearest_neighbors", handle, run, corrected=corrected, k=k, node=int(node))
    return QueryResult(idx=ids[0], val=vals[0], emb_id=handle.emb_id, corrected=corrected,
                       panels=n_panels, bytes_read=bytes_read, latency_ms=dt_ms)


def commute_block(store, rows, cols, *, emb_id: str | None = None,
                  corrected: bool = False) -> np.ndarray:
    """The (rows x cols) commute-distance block from a persisted artifact.

    ``vol * ||z_i - z_j||^2`` (raw) or ``||z_i - z_j||^2 - 1/deg_i -
    1/deg_j`` (corrected), in float64 on the host from O(|rows| + |cols|)
    gathered Z rows.  Out-of-range ids raise ``IndexError``.
    """
    handle = _resolve_handle(store, emb_id)
    n = handle.shape[0]
    validate_node_indices("rows", rows, n)
    validate_node_indices("cols", cols, n)
    rows = np.asarray(rows).reshape(-1)
    cols = np.asarray(cols).reshape(-1)
    zi = handle.read_rows(rows).astype(np.float64)
    zj = handle.read_rows(cols).astype(np.float64)
    dist2 = np.maximum((zi * zi).sum(-1)[:, None] + (zj * zj).sum(-1)[None, :] - 2.0 * zi @ zj.T,
                       0.0)
    if corrected:
        inv = handle.inv_deg().astype(np.float64)
        return (dist2 - inv[rows][:, None] - inv[cols][None, :]).astype(np.float32)
    return (handle.vol * dist2).astype(np.float32)


def rank_auc(labels, scores) -> float:
    """ROC-AUC via tie-averaged ranks (Mann-Whitney U).

    ``labels`` boolean-ish (1 = anomaly), ``scores`` higher-is-more-anomalous.
    """
    labels = np.asarray(labels).astype(bool).reshape(-1)
    scores = np.asarray(scores, np.float64).reshape(-1)
    if labels.shape != scores.shape:
        raise ValueError(f"labels {labels.shape} vs scores {scores.shape}")
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("rank_auc needs at least one positive and one negative")
    order = np.argsort(scores, kind="mergesort")
    _, inverse, counts = np.unique(scores[order], return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    ranks = np.empty(scores.size, np.float64)
    ranks[order] = ((ends - counts + 1 + ends) / 2.0)[inverse]
    u = ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def main(argv: list[str] | None = None) -> int:
    from repro_torch.store.embstore import EmbeddingStore

    p = argparse.ArgumentParser(
        prog="caddelag-query-torch",
        description="Serve top-k anomaly / nearest-neighbor queries from a "
        "persisted embedding artifact (no chain build, no solve).",
    )
    p.add_argument("--store", required=True, help="EmbeddingStore directory")
    p.add_argument("--id", default=None, help="embedding id (default: latest)")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--corrected", action="store_true",
                   help="von Luxburg amplified score C/vol - 1/deg_i - 1/deg_j")
    p.add_argument("--neighbors", type=int, default=None, metavar="NODE",
                   help="nearest neighbors of NODE instead of top anomalies")
    p.add_argument("--prefetch-depth", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the panel_topk_update kernel; cpu its plain version")
    args = p.parse_args(argv)

    store = EmbeddingStore.open(args.store)
    handle = _resolve_handle(store, args.id)
    print(
        f"[caddelag-query] store={args.store} id={handle.emb_id} "
        f"n={handle.shape[0]} k={handle.shape[1]} "
        f"panel_rows={handle.panel_rows} codec={store.manifest.codec} "
        f"scorer={'corrected' if args.corrected else 'raw'} device={args.device}"
    )
    opts = dict(corrected=args.corrected, prefetch_depth=args.prefetch_depth, device=args.device)
    if args.neighbors is not None:
        res = nearest_neighbors(handle, args.neighbors, args.top_k, **opts)
        print(f"[caddelag-query] nearest neighbors of node {args.neighbors}:")
    else:
        res = top_anomalies_from_store(handle, args.top_k, **opts)
        print("[caddelag-query] top anomalies (commute distance to centroid):")
    for rank, (i, v) in enumerate(zip(res.idx, res.val)):
        if i < 0:
            break
        print(f"  #{rank + 1:<3d} node {int(i):<8d} score {float(v):.6g}")
    print(f"[caddelag-query] panels={res.panels} bytes_read={res.bytes_read} "
          f"latency_ms={res.latency_ms:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
