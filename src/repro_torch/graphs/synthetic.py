"""Synthetic graph-sequence generators (paper section 4.2.1), built on the device.

Port of :mod:`repro.graphs.synthetic`.  The paper's quantitative benchmark
(:func:`gmm_graph_sequence`) draws points from a 4-component 2-D Gaussian
mixture, builds the fully connected similarity graph P = exp(-d(i, j)),
perturbs it into Q and injects uniform edges R: A1 = P, A2 = Q + (R + R^T)/2,
and the endpoints of injected *inter-cluster* edges are the ground truth.
The climate generators put smooth random fields on a lat/lon grid with a
localized event.

The random draws are the JAX package's numpy draws, in the same order, so
node features, injections and truth are bitwise the same; the n x n
adjacency is then built on ``device`` from the features, or with ``ctx`` (a
device grid) tile by tile, each tile on its grid device, so the graph never
exists in one place (the grid's home device then takes the place of
``device``).  torch's ``exp``
and ``sqrt`` may differ from XLA's in the last ulp, so the graphs are
allclose to the JAX package's, not bitwise.  :func:`gmm_store_sequence`
writes a sequence into a tile store tile by tile, in numpy alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core.distmatrix import DistContext, DistMatrix, build_from_nodes
from repro_torch.device import resolve_device


def _device(device, ctx: DistContext | None) -> torch.device:
    return resolve_device(device if ctx is None else ctx.home)


def _add_dense(a, r: np.ndarray, dtype, dev: torch.device, ctx: DistContext | None,
               r_dtype=torch.float32):
    """a + r (a host matrix taken as ``r_dtype``), cast to ``dtype``, on ``a``'s
    device or grid."""
    r = torch.from_numpy(r).to(r_dtype)
    if ctx is None or ctx.is_trivial:
        return (a + r.to(dev)).to(dtype)
    return a.add_(ctx.put_matrix(r)).to(dtype)  # a is a fresh build: add in place


def gmm_points(n: int, seed: int = 0, spread: float = 4.0) -> tuple[np.ndarray, np.ndarray]:
    """n points from a 4-component 2-D GMM; returns (points, component_ids)."""
    rng = np.random.default_rng(seed)
    means = spread * np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], np.float64)
    comp = rng.integers(0, 4, size=n)
    pts = means[comp] + rng.normal(size=(n, 2))
    return pts.astype(np.float32), comp


def _sq_dists(xi: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    return torch.sum((xi[:, None, :] - xj[None, :, :]) ** 2, dim=-1)


def similarity_graph(
    feats, *, bandwidth: float = 1.0, dtype=torch.float32, device="cuda",
    ctx: DistContext | None = None,
):
    """A[i, j] = exp(-||x_i - x_j|| / bandwidth), zero diagonal."""

    def kern(xi, xj):
        return torch.exp(-torch.sqrt(torch.clamp(_sq_dists(xi, xj), min=1e-12)) / bandwidth)

    f = torch.as_tensor(np.asarray(feats, np.float32), device=_device(device, ctx))
    return build_from_nodes(f, kern, dtype=dtype, ctx=ctx)


def gaussian_kernel_graph(
    feats, *, sigma: float, dtype=torch.float32, device="cuda", ctx: DistContext | None = None,
):
    """A[i, j] = exp(-||p_i - p_j||^2 / (2 sigma^2)), zero diagonal -- the climate kernel."""

    def kern(xi, xj):
        return torch.exp(-_sq_dists(xi, xj) / (2.0 * sigma**2))

    f = torch.as_tensor(np.asarray(feats, np.float32), device=_device(device, ctx))
    return build_from_nodes(f, kern, dtype=dtype, ctx=ctx)


def _smooth_field(x: np.ndarray, n_lat: int, n_lon: int, passes: int = 8) -> np.ndarray:
    """``passes`` rounds of a 5-point average on the periodic lat/lon grid."""
    f = x.reshape(n_lat, n_lon, -1)
    for _ in range(passes):
        f = 0.5 * f + 0.125 * (
            np.roll(f, 1, 0) + np.roll(f, -1, 0) + np.roll(f, 1, 1) + np.roll(f, -1, 1)
        )
    return f.reshape(n_lat * n_lon, -1)


def _event_nodes(rng: np.random.Generator, n_lat: int, n_lon: int,
                 event_frac: float) -> np.ndarray:
    """The ``event_frac`` of grid nodes nearest a random centre (one draw of ``rng``)."""
    n = n_lat * n_lon
    centre = rng.integers(0, n)
    ci, cj = divmod(int(centre), n_lon)
    ii, jj = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    dist = ((ii - ci) ** 2 + (jj - cj) ** 2).reshape(-1)
    return np.argsort(dist)[:max(1, int(event_frac * n))]


@dataclass
class GMMSequence:
    a1: torch.Tensor
    a2: torch.Tensor
    anomalous_nodes: np.ndarray  # ground truth, strongest first
    components: np.ndarray


def gmm_graph_sequence(
    n: int,
    *,
    seed: int = 0,
    noise: float = 0.05,
    inject_p: float = 0.05,
    dtype=torch.float32,
    device="cuda",
    ctx: DistContext | None = None,
) -> GMMSequence:
    """The paper's synthetic transition: A1 = P, A2 = Q + (R + R^T)/2.

    Each of the n^2 entries of R is injected with probability ``inject_p``
    (then symmetrized); the truth is the nodes with an injected
    *inter-cluster* edge, ranked by their total injected inter-cluster
    weight.  The two n x n uniform draws
    behind R are made on the host (as in the JAX package).
    """
    dev = _device(device, ctx)
    rng = np.random.default_rng(seed)
    pts, comp = gmm_points(n, seed)
    a1 = similarity_graph(pts, dtype=dtype, device=dev, ctx=ctx)

    pts2 = pts + noise * rng.normal(size=pts.shape).astype(np.float32)
    q = similarity_graph(pts2, dtype=dtype, device=dev, ctx=ctx)

    mask = rng.random((n, n)) < inject_p
    r = np.where(mask, rng.random((n, n)), 0.0).astype(np.float32)
    del mask
    r_sym = (r + r.T) / 2.0
    del r
    np.fill_diagonal(r_sym, 0.0)
    a2 = _add_dense(q, r_sym, dtype, dev, ctx)
    del q

    inter = (comp[:, None] != comp[None, :]) & (r_sym > 0)
    truth = np.unique(np.nonzero(inter.any(axis=1))[0])
    strength = (r_sym * inter).sum(1)
    truth = truth[np.argsort(-strength[truth])]
    return GMMSequence(a1=a1, a2=a2, anomalous_nodes=truth, components=comp)


def climate_like_sequence(
    n_lat: int,
    n_lon: int,
    *,
    seed: int = 0,
    sigma: float = 1.0,
    event_frac: float = 0.02,
    event_strength: float = 6.0,
    dtype=torch.float32,
    device="cuda",
    ctx: DistContext | None = None,
):
    """Two smooth precipitation-like fields; the second has a localized event.

    Returns ``(a1, a2, event_nodes)``.  Node features are 12-month profiles
    smoothed over the grid (a stand-in for NCEP monthly means).
    """
    dev = _device(device, ctx)
    rng = np.random.default_rng(seed)
    n = n_lat * n_lon
    base = _smooth_field(rng.normal(size=(n, 12)).astype(np.float32), n_lat, n_lon)
    drift = _smooth_field(0.1 * rng.normal(size=(n, 12)).astype(np.float32), n_lat, n_lon)

    event_nodes = _event_nodes(rng, n_lat, n_lon, event_frac)
    bump = np.zeros((n, 12), np.float32)
    bump[event_nodes] = event_strength
    field2 = base + drift + _smooth_field(bump, n_lat, n_lon, passes=2)

    a1 = gaussian_kernel_graph(base, sigma=sigma, dtype=dtype, device=dev, ctx=ctx)
    a2 = gaussian_kernel_graph(field2, sigma=sigma, dtype=dtype, device=dev, ctx=ctx)
    return a1, a2, event_nodes


@dataclass
class SnapshotSequence:
    """A lazily-built sequence of T snapshots plus per-transition truth.

    ``truth[t]`` holds the ground-truth anomalous nodes of transition
    (t, t+1), strongest first (may be empty); ``labels`` the per-node 0/1
    planted outliers of the labeled GMM mode.
    """

    t_steps: int
    truth: list[np.ndarray]
    components: np.ndarray | None = None
    event_nodes: np.ndarray | None = None
    labels: np.ndarray | None = None
    _build: Callable[[int], torch.Tensor] = field(default=None, repr=False)

    def snapshots(self) -> Iterator[torch.Tensor]:
        for t in range(self.t_steps):
            yield self._build(t)


def _gmm_injection(n: int, seed: int, t: int, inject_p: float) -> np.ndarray:
    """Deterministic per-step injected-edge matrix R_t + R_t^T (numpy)."""
    rng = np.random.default_rng((seed + 1) * 1_000_003 + t)
    mask = rng.random((n, n)) < inject_p
    r = np.where(mask, rng.random((n, n)), 0.0).astype(np.float32)
    r_sym = (r + r.T) / 2.0
    np.fill_diagonal(r_sym, 0.0)
    return r_sym


def _dimmed_similarity_kern(bandwidth: float):
    """exp(-d/bw) * s_i * s_j over (x, y, scale) features: the scale column
    dims a node's whole row and column (a low-degree node at a normal spot)."""

    def kern(xi, xj):
        d2 = _sq_dists(xi[:, :2], xj[:, :2])
        sim = torch.exp(-torch.sqrt(torch.clamp(d2, min=1e-12)) / bandwidth)
        return sim * xi[:, None, 2] * xj[None, :, 2]

    return kern


def gmm_snapshot_sequence(
    n: int,
    t_steps: int,
    *,
    seed: int = 0,
    noise: float = 0.05,
    inject_p: float = 0.05,
    inject_steps: set[int] | None = None,
    drift_nodes: int | None = None,
    anomaly_nodes: int | np.ndarray | None = None,
    anomaly_scale: float = 12.0,
    dim_nodes: int = 0,
    dim_factor: float = 0.05,
    dtype=torch.float32,
    device="cuda",
    ctx: DistContext | None = None,
) -> SnapshotSequence:
    """T-snapshot GMM sequence: drifting points plus per-step edge injections.

    Snapshot 0 is the clean similarity graph; each later snapshot drifts the
    points by ``noise`` (only ``drift_nodes`` random movers when given) and,
    at steps in ``inject_steps`` (default every t >= 1), adds R_t.  Truth for
    (t, t+1) is the inter-cluster injected nodes of both endpoints.

    ``anomaly_nodes`` (a count or explicit ids) is the labeled mode of the
    query path's ROC-AUC bar: those nodes move into one tight clump at radius
    ``anomaly_scale`` (structural outliers), ``dim_nodes`` normal nodes have
    their similarity rows and columns scaled by ``dim_factor`` (low-degree
    distractors, labeled 0), and the sequence carries ``labels`` (n,) 0/1.
    """
    if t_steps < 2:
        raise ValueError("a sequence needs at least 2 snapshots")
    dev = _device(device, ctx)
    inject_steps = set(range(1, t_steps)) if inject_steps is None else set(inject_steps)
    rng = np.random.default_rng(seed)
    pts0, comp = gmm_points(n, seed)

    labels = scale = None
    if anomaly_nodes is not None:
        if np.ndim(anomaly_nodes) == 0:
            outliers = rng.choice(n, size=min(int(anomaly_nodes), n), replace=False)
        else:
            outliers = np.asarray(anomaly_nodes, np.int64).reshape(-1)
        labels = np.zeros(n, np.int8)
        labels[outliers] = 1
        theta = float(rng.uniform(0, 2 * np.pi))
        centre = anomaly_scale * np.array([np.cos(theta), np.sin(theta)], np.float32)
        pts0 = pts0.copy()
        pts0[outliers] = centre + 0.3 * rng.normal(size=(outliers.size, 2)).astype(np.float32)
        scale = np.ones(n, np.float32)
        if dim_nodes:
            normal = np.setdiff1d(np.arange(n), outliers)
            dimmed = rng.choice(normal, size=min(int(dim_nodes), normal.size), replace=False)
            scale[dimmed] = float(dim_factor)

    pts_all = [pts0]
    for _ in range(1, t_steps):
        step = noise * rng.normal(size=pts0.shape).astype(np.float32)
        if drift_nodes is not None:
            movers = rng.choice(n, size=min(int(drift_nodes), n), replace=False)
            mask = np.zeros((n, 1), np.float32)
            mask[movers] = 1.0
            step = step * mask
        pts_all.append(pts_all[-1] + step)

    inter = comp[:, None] != comp[None, :]
    strength = {
        t: (_gmm_injection(n, seed, t, inject_p) * inter).sum(1) for t in sorted(inject_steps)
    }
    truth = []
    for t in range(t_steps - 1):
        s = np.zeros(n, np.float32)
        for endpoint in (t, t + 1):
            if endpoint in strength:
                s = s + strength[endpoint]
        nodes = np.nonzero(s > 0)[0]
        truth.append(nodes[np.argsort(-s[nodes])])

    def build(t: int):
        if scale is None:
            a = similarity_graph(pts_all[t], dtype=dtype, device=dev, ctx=ctx)
        else:
            feats = np.concatenate([pts_all[t], scale[:, None]], axis=1)
            a = build_from_nodes(torch.from_numpy(feats).to(dev), _dimmed_similarity_kern(1.0),
                                 dtype=dtype, ctx=ctx)
        if t in inject_steps:
            a = _add_dense(a, _gmm_injection(n, seed, t, inject_p), dtype, dev, ctx,
                           r_dtype=dtype)
        return a

    return SnapshotSequence(t_steps=t_steps, truth=truth, components=comp, labels=labels,
                            _build=build)


def climate_snapshot_sequence(
    n_lat: int,
    n_lon: int,
    t_steps: int,
    *,
    seed: int = 0,
    sigma: float = 1.0,
    drift: float = 0.1,
    event_steps: set[int] | None = None,
    event_frac: float = 0.02,
    event_strength: float = 6.0,
    dtype=torch.float32,
    device="cuda",
    ctx: DistContext | None = None,
) -> SnapshotSequence:
    """T-month climate-like sequence on an n_lat x n_lon grid, one localized event.

    Node features are 12-month profiles, smoothed over the grid; they drift
    month to month, and at ``event_steps`` (default: the middle snapshot) a
    localized bump is superimposed.  Truth for (t, t+1) is the event region
    when the event appears or disappears at that transition.
    """
    if t_steps < 2:
        raise ValueError("a sequence needs at least 2 snapshots")
    dev = _device(device, ctx)
    event_steps = {t_steps // 2} if event_steps is None else set(event_steps)
    rng = np.random.default_rng(seed)
    n = n_lat * n_lon

    base = _smooth_field(rng.normal(size=(n, 12)).astype(np.float32), n_lat, n_lon)
    fields = [base]
    for _ in range(1, t_steps):
        step = drift * rng.normal(size=(n, 12)).astype(np.float32)
        fields.append(fields[-1] + _smooth_field(step, n_lat, n_lon))

    event_nodes = _event_nodes(rng, n_lat, n_lon, event_frac)
    bump = np.zeros((n, 12), np.float32)
    bump[event_nodes] = event_strength
    bump = _smooth_field(bump, n_lat, n_lon, passes=2)

    truth = []
    for t in range(t_steps - 1):
        toggled = (t in event_steps) != ((t + 1) in event_steps)
        truth.append(event_nodes.copy() if toggled else np.empty(0, np.int64))

    def build(t: int):
        f = fields[t] + (bump if t in event_steps else 0.0)
        return gaussian_kernel_graph(f, sigma=sigma, dtype=dtype, device=dev, ctx=ctx)

    return SnapshotSequence(
        t_steps=t_steps, truth=truth, event_nodes=event_nodes, _build=build
    )


def store_snapshot_sequence(store, seq: SnapshotSequence, *, ids: list[str] | None = None) -> list[str]:
    """Write a :class:`SnapshotSequence` into a :class:`repro_torch.store.TileStore`.

    Snapshots are built one at a time on their device (or device grid),
    copied to the host (a grid's tiles one by one), tiled into the store and
    dropped: at most one snapshot is resident during the write.
    Already-committed ids are skipped, so an interrupted write resumes where
    it stopped.
    """
    ids = ids if ids is not None else [f"t{t:04d}" for t in range(seq.t_steps)]
    if len(ids) != seq.t_steps:
        raise ValueError(f"{len(ids)} ids for {seq.t_steps} snapshots")
    committed = set(store.snapshot_ids)
    for sid, a in zip(ids, seq.snapshots()):
        if sid not in committed:
            store.put_snapshot(sid, a.numpy() if isinstance(a, DistMatrix) else a.cpu().numpy())
    return ids


def gmm_store_sequence(
    store,
    t_steps: int,
    *,
    seed: int = 0,
    noise: float = 0.05,
    bandwidth: float = 1.0,
) -> list[str]:
    """Write a drifting-GMM similarity sequence into ``store`` tile by tile.

    Pure numpy: only the (n, 2) point table is resident, and each
    ``exp(-d(i, j) / bandwidth)`` tile is computed from it and written on its
    own, so the sequence may be far larger than host RAM.  The kernel of
    :func:`similarity_graph`; no injections and no truth.  Already-committed
    snapshots are skipped.
    """
    if t_steps < 1:
        raise ValueError("need at least 1 snapshot")
    n = store.n
    pts, _ = gmm_points(n, seed)
    rng = np.random.default_rng(seed)
    ids = []
    for t in range(t_steps):
        sid = f"t{t:04d}"

        def tile_fn(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
            xi, xj = pts[rows], pts[cols]
            d2 = ((xi[:, None, :] - xj[None, :, :]) ** 2).sum(-1)
            blk = np.exp(-np.sqrt(np.maximum(d2, 1e-12)) / bandwidth).astype(np.float32)
            blk[rows[:, None] == cols[None, :]] = 0.0
            return blk

        if sid not in store.snapshot_ids:
            store.put_snapshot_tiles(sid, tile_fn)
        ids.append(sid)
        pts = pts + noise * rng.normal(size=pts.shape).astype(np.float32)
    return ids
