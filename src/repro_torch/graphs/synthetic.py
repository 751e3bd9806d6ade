"""Synthetic graph-sequence generators (paper section 4.2.1), built on the device.

Port of :mod:`repro.graphs.synthetic`.  The random node features come from
the same numpy draws as the JAX package's, so the fixtures agree; the n x n
adjacency is then built on ``device`` from the features.  torch's ``exp``
and ``sqrt`` may differ from XLA's in the last ulp, so the graphs are
allclose to the JAX package's, not bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core.distmatrix import build_from_nodes
from repro_torch.device import resolve_device


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
    feats, *, bandwidth: float = 1.0, dtype=torch.float32, device="cuda"
) -> torch.Tensor:
    """A[i, j] = exp(-||x_i - x_j|| / bandwidth), zero diagonal."""

    def kern(xi, xj):
        return torch.exp(-torch.sqrt(torch.clamp(_sq_dists(xi, xj), min=1e-12)) / bandwidth)

    f = torch.as_tensor(np.asarray(feats, np.float32), device=resolve_device(device))
    return build_from_nodes(f, kern, dtype=dtype)


def gaussian_kernel_graph(
    feats, *, sigma: float, dtype=torch.float32, device="cuda"
) -> torch.Tensor:
    """A[i, j] = exp(-||p_i - p_j||^2 / (2 sigma^2)), zero diagonal -- the climate kernel."""

    def kern(xi, xj):
        return torch.exp(-_sq_dists(xi, xj) / (2.0 * sigma**2))

    f = torch.as_tensor(np.asarray(feats, np.float32), device=resolve_device(device))
    return build_from_nodes(f, kern, dtype=dtype)


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
    dev = resolve_device(device)
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

    def build(t: int) -> torch.Tensor:
        if scale is None:
            a = similarity_graph(pts_all[t], dtype=dtype, device=dev)
        else:
            feats = np.concatenate([pts_all[t], scale[:, None]], axis=1)
            a = build_from_nodes(torch.from_numpy(feats).to(dev), _dimmed_similarity_kern(1.0),
                                 dtype=dtype)
        if t in inject_steps:
            a = a + torch.from_numpy(_gmm_injection(n, seed, t, inject_p)).to(dev, dtype)
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
) -> SnapshotSequence:
    """T-month climate-like sequence on an n_lat x n_lon grid, one localized event.

    Node features are 12-month profiles, smoothed over the grid; they drift
    month to month, and at ``event_steps`` (default: the middle snapshot) a
    localized bump is superimposed.  Truth for (t, t+1) is the event region
    when the event appears or disappears at that transition.
    """
    if t_steps < 2:
        raise ValueError("a sequence needs at least 2 snapshots")
    dev = resolve_device(device)
    event_steps = {t_steps // 2} if event_steps is None else set(event_steps)
    rng = np.random.default_rng(seed)
    n = n_lat * n_lon

    def smooth_field(x: np.ndarray, passes: int = 8) -> np.ndarray:
        f = x.reshape(n_lat, n_lon, -1)
        for _ in range(passes):
            f = 0.5 * f + 0.125 * (
                np.roll(f, 1, 0) + np.roll(f, -1, 0) + np.roll(f, 1, 1) + np.roll(f, -1, 1)
            )
        return f.reshape(n, -1)

    base = smooth_field(rng.normal(size=(n, 12)).astype(np.float32))
    fields = [base]
    for _ in range(1, t_steps):
        step = smooth_field(drift * rng.normal(size=(n, 12)).astype(np.float32))
        fields.append(fields[-1] + step)

    n_event = max(1, int(event_frac * n))
    centre = rng.integers(0, n)
    ci, cj = divmod(int(centre), n_lon)
    ii, jj = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    dist = ((ii - ci) ** 2 + (jj - cj) ** 2).reshape(-1)
    event_nodes = np.argsort(dist)[:n_event]
    bump = np.zeros((n, 12), np.float32)
    bump[event_nodes] = event_strength
    bump = smooth_field(bump, passes=2)

    truth = []
    for t in range(t_steps - 1):
        toggled = (t in event_steps) != ((t + 1) in event_steps)
        truth.append(event_nodes.copy() if toggled else np.empty(0, np.int64))

    def build(t: int) -> torch.Tensor:
        f = fields[t] + (bump if t in event_steps else 0.0)
        return gaussian_kernel_graph(f, sigma=sigma, dtype=dtype, device=dev)

    return SnapshotSequence(
        t_steps=t_steps, truth=truth, event_nodes=event_nodes, _build=build
    )


def store_snapshot_sequence(store, seq: SnapshotSequence, *, ids: list[str] | None = None) -> list[str]:
    """Write a :class:`SnapshotSequence` into a :class:`repro_torch.store.TileStore`.

    Snapshots are built one at a time on their device, copied to the host,
    tiled into the store and dropped: at most one snapshot is resident
    during the write.  Already-committed ids are skipped, so an interrupted
    write resumes where it stopped.
    """
    ids = ids if ids is not None else [f"t{t:04d}" for t in range(seq.t_steps)]
    if len(ids) != seq.t_steps:
        raise ValueError(f"{len(ids)} ids for {seq.t_steps} snapshots")
    committed = set(store.snapshot_ids)
    for sid, a in zip(ids, seq.snapshots()):
        if sid not in committed:
            store.put_snapshot(sid, a.cpu().numpy())
    return ids
