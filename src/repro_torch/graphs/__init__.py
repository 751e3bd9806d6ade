"""Synthetic graph-sequence generators, built on the device."""

from repro_torch.graphs.synthetic import (
    SnapshotSequence,
    climate_like_sequence,
    climate_snapshot_sequence,
    gaussian_kernel_graph,
    gmm_graph_sequence,
    gmm_points,
    gmm_snapshot_sequence,
    gmm_store_sequence,
    similarity_graph,
    store_snapshot_sequence,
)

__all__ = [
    "SnapshotSequence",
    "climate_like_sequence",
    "climate_snapshot_sequence",
    "gaussian_kernel_graph",
    "gmm_graph_sequence",
    "gmm_points",
    "gmm_snapshot_sequence",
    "gmm_store_sequence",
    "similarity_graph",
    "store_snapshot_sequence",
]
