"""Stores on host RAM or disk: tiled dense adjacencies and embedding artifacts.

Port of :mod:`repro.store`: the snapshot store, the panel pipeline, and the
embedding store the query read path serves from.
"""

from repro_torch.store.embstore import (
    EMB_CODECS,
    EmbeddingHandle,
    EmbeddingStore,
    EmbManifest,
    default_panel_rows,
)
from repro_torch.store.pipeline import (
    DEFAULT_PREFETCH_DEPTH,
    CachingHandle,
    PanelPipeline,
    fetch_panel_encoded_info,
    fetch_panel_info,
)
from repro_torch.store.tilestore import (
    CODECS,
    MANIFEST_NAME,
    SnapshotHandle,
    SnapshotWriter,
    StoreManifest,
    TileCodec,
    TileStore,
    resolve_codec,
)

__all__ = [
    "CODECS",
    "CachingHandle",
    "DEFAULT_PREFETCH_DEPTH",
    "EMB_CODECS",
    "EmbManifest",
    "EmbeddingHandle",
    "EmbeddingStore",
    "MANIFEST_NAME",
    "PanelPipeline",
    "SnapshotHandle",
    "SnapshotWriter",
    "StoreManifest",
    "TileCodec",
    "TileStore",
    "default_panel_rows",
    "fetch_panel_encoded_info",
    "fetch_panel_info",
    "resolve_codec",
]
