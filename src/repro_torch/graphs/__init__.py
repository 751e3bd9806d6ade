"""Synthetic graph-sequence generators, built on the device."""

from repro_torch.graphs.synthetic import (
    SnapshotSequence,
    climate_snapshot_sequence,
    gaussian_kernel_graph,
    gmm_points,
    gmm_snapshot_sequence,
    similarity_graph,
    store_snapshot_sequence,
)

__all__ = [
    "SnapshotSequence",
    "climate_snapshot_sequence",
    "gaussian_kernel_graph",
    "gmm_points",
    "gmm_snapshot_sequence",
    "similarity_graph",
    "store_snapshot_sequence",
]
