"""The benchmark's one graph-sequence generator, driven by a configuration and a traffic mix.

A configuration's ``graph`` says what the nodes are and how an edge is
weighed; a traffic mix says how the snapshots move from one to the next.
Everything is drawn on the run's device from ``--seed``: a ``torch.Generator``
there for the node features and their drift, and a numpy generator keyed on
(seed, snapshot) for the few injected edges, which are then scattered on the
device.  The same seed gives the same snapshots, bit for bit, on one device.

The configuration's ``n_nodes`` counts the nodes.  Graph kinds (``graph.kind``):

- ``grid_field``: ``n_lat x n_lon`` grid points, each with ``features``
  values of a smooth random field (``smooth_passes`` rounds of a periodic
  5-point average of unit normals); positions are the grid indices.
- ``gmm_points``: points of a ``dims``-D Gaussian mixture, one
  unit-variance component at each corner of a cube of half-side ``spread``
  (``components`` of them); positions are the points.

Edge kernels (``graph.kernel``), on the features, with a zero diagonal:
``gaussian`` exp(-|x_i - x_j|^2 / (2 sigma^2)) and ``exp_distance``
exp(-|x_i - x_j| / bandwidth).

Traffic keys: ``drift`` (each snapshot's features move by ``drift`` times a
unit normal, smoothed over the grid by ``drift_smooth_passes``), ``event_every``
(snapshots t > 0 with t % event_every == 0 carry an event: ``event_strength``
added to every feature of the ``event_frac`` of nodes nearest a random node,
smoothed by ``event_smooth_passes`` on a grid; the event leaves with its
snapshot), and ``inject_pairs`` (that many node pairs, drawn afresh each
snapshot after the first, get a uniform [0, 1) weight added to both of their
entries).
"""

from __future__ import annotations

import numpy as np
import torch

GRAPH_KINDS = ("grid_field", "gmm_points")
KERNELS = ("gaussian", "exp_distance")
_SEED_MOD = 1 << 63


def n_nodes(config: dict) -> int:
    """The configuration's ``n_nodes``, checked against its grid."""
    graph, n = config["graph"], int(config["n_nodes"])
    if graph["kind"] not in GRAPH_KINDS:
        raise ValueError(f"unknown graph kind {graph['kind']!r}; want one of {GRAPH_KINDS}")
    if graph["kind"] == "grid_field" and int(graph["n_lat"]) * int(graph["n_lon"]) != n:
        raise ValueError(f"n_nodes {n} is not the grid's {graph['n_lat']} x {graph['n_lon']}")
    return n


def _smooth(x: torch.Tensor, graph: dict, passes: int) -> torch.Tensor:
    """``passes`` rounds of a 5-point average on the periodic grid (no-op off a grid)."""
    if graph["kind"] != "grid_field" or passes <= 0:
        return x
    f = x.reshape(int(graph["n_lat"]), int(graph["n_lon"]), -1)
    for _ in range(passes):
        f = 0.5 * f + 0.125 * (f.roll(1, 0) + f.roll(-1, 0) + f.roll(1, 1) + f.roll(-1, 1))
    return f.reshape(x.shape)


def adjacency(feats: torch.Tensor, graph: dict) -> torch.Tensor:
    """The dense (n, n) float32 graph of the features (distances from one product)."""
    kernel = graph["kernel"]
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; want one of {KERNELS}")
    sq = (feats * feats).sum(dim=1)
    a = torch.addmm(sq[:, None], feats, feats.T, alpha=-2.0)
    a.add_(sq[None, :]).clamp_(min=0.0)
    if kernel == "gaussian":
        a.mul_(-1.0 / (2.0 * float(graph["sigma"]) ** 2))
    else:
        a.clamp_(min=1e-12).sqrt_().mul_(-1.0 / float(graph["bandwidth"]))
    a.exp_().triu_(1)  # the upper triangle, mirrored: exactly symmetric, a zero diagonal
    return a + a.T


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """A 0-dim int64 sum of the float32 bits: cheap, on the device, no sync."""
    return x.contiguous().view(torch.int32).sum(dtype=torch.int64)


class SnapshotStream:
    """Snapshot t = 0, 1, 2, ... of one configuration under one traffic mix."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.graph, self.traffic = config["graph"], traffic
        self.device = torch.device(device)
        self.seed = int(seed) % _SEED_MOD
        self.n = n_nodes(config)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        self.t = -1
        self.base = self._initial()  # the features before any event
        self.pos = self._positions()

    def _normal(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)

    def _initial(self) -> torch.Tensor:
        g = self.graph
        if g["kind"] == "grid_field":
            x = self._normal(self.n, int(g["features"]))
            return _smooth(x, g, int(g["smooth_passes"]))
        comps, dims = int(g["components"]), int(g["dims"])
        corners = torch.tensor(
            [[1.0 if (c >> b) & 1 else -1.0 for b in range(dims)] for c in range(comps)],
            device=self.device)
        comp = torch.randint(0, comps, (self.n,), generator=self.gen, device=self.device)
        return float(g["spread"]) * corners[comp] + self._normal(self.n, dims)

    def _positions(self) -> torch.Tensor:
        if self.graph["kind"] == "grid_field":
            n_lon = int(self.graph["n_lon"])
            ids = torch.arange(self.n, device=self.device)
            return torch.stack([ids // n_lon, ids % n_lon], dim=1).to(torch.float32)
        return self.base.clone()

    def _event(self) -> torch.Tensor:
        tr = self.traffic
        centre = torch.randint(0, self.n, (1,), generator=self.gen, device=self.device)
        dist = ((self.pos - self.pos[centre]) ** 2).sum(dim=1)
        m = max(1, int(float(tr["event_frac"]) * self.n))
        nodes = torch.sort(dist, stable=True).indices[:m]
        bump = torch.zeros_like(self.base)
        bump[nodes] = float(tr["event_strength"])
        return _smooth(bump, self.graph, int(tr.get("event_smooth_passes", 0)))

    def _injections(self, t: int):
        count = int(self.traffic.get("inject_pairs", 0))
        if count <= 0 or t == 0:
            return None
        rng = np.random.default_rng([self.seed, t])
        ij = rng.integers(0, self.n, size=(count, 2))
        ij = ij[ij[:, 0] != ij[:, 1]]
        ij = np.unique(np.sort(ij, axis=1), axis=0)  # one entry per unordered pair
        w = rng.random(len(ij)).astype(np.float32)
        return torch.from_numpy(ij).to(self.device), torch.from_numpy(w).to(self.device)

    def next_features(self):
        """Advance to the next snapshot: (features, injections or None)."""
        self.t += 1
        tr = self.traffic
        if self.t > 0 and float(tr.get("drift", 0.0)) > 0.0:
            step = float(tr["drift"]) * self._normal(*self.base.shape)
            passes = int(tr.get("drift_smooth_passes", 0))
            self.base = self.base + _smooth(step, self.graph, passes)
        feats = self.base
        every = int(tr.get("event_every", 0))
        if every > 0 and self.t > 0 and self.t % every == 0:
            feats = feats + self._event()
        return feats, self._injections(self.t)

    def build(self, feats: torch.Tensor, inj) -> torch.Tensor:
        a = adjacency(feats, self.graph)
        if inj is not None:
            ij, w = inj
            a.index_put_((ij[:, 0], ij[:, 1]), w, accumulate=True)
            a.index_put_((ij[:, 1], ij[:, 0]), w, accumulate=True)
        return a

    def next(self):
        """The next snapshot: (adjacency, fingerprint of its features)."""
        feats, inj = self.next_features()
        return self.build(feats, inj), fingerprint(feats)

