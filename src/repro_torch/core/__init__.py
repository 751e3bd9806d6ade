"""Core CADDeLaG pipeline on one device: chain, solve, embed, score, sequence, query."""

from repro_torch.core.cad import CADResult, detect_anomalies, node_anomaly_scores, top_anomalies
from repro_torch.core.chain import ChainOperator, chain_build_count, chain_product
from repro_torch.core.distmatrix import (
    SCHEDULES,
    add_scaled_identity,
    build_from_nodes,
    matmul,
    matmul_rowblock,
)
from repro_torch.core.embedding import (
    CommuteConfig,
    Embedding,
    commute_distance_block,
    commute_time_embedding,
    edge_projection,
    exact_commute_distances,
    validate_node_indices,
)
from repro_torch.core.query import (
    QueryResult,
    commute_block,
    nearest_neighbors,
    rank_auc,
    top_anomalies_from_store,
)
from repro_torch.core.sequence import SequenceDetector, SequenceResult, detect_sequence_anomalies
from repro_torch.core.solvers import SolveReport, SolverSpec, estimate_rho, solve
from repro_torch.core.tiles import is_streamable, reset_stream_stats, stream_stats, tile_stream

__all__ = [
    "CADResult",
    "ChainOperator",
    "CommuteConfig",
    "Embedding",
    "QueryResult",
    "SCHEDULES",
    "SequenceDetector",
    "SequenceResult",
    "SolveReport",
    "SolverSpec",
    "add_scaled_identity",
    "build_from_nodes",
    "chain_build_count",
    "chain_product",
    "commute_block",
    "commute_distance_block",
    "commute_time_embedding",
    "detect_anomalies",
    "detect_sequence_anomalies",
    "edge_projection",
    "estimate_rho",
    "exact_commute_distances",
    "is_streamable",
    "matmul",
    "matmul_rowblock",
    "nearest_neighbors",
    "node_anomaly_scores",
    "rank_auc",
    "reset_stream_stats",
    "solve",
    "stream_stats",
    "tile_stream",
    "top_anomalies",
    "top_anomalies_from_store",
    "validate_node_indices",
]
