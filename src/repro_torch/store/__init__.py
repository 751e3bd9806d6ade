"""Out-of-core snapshot store: tiled dense adjacencies on host RAM or disk.

Port of :mod:`repro.store` (the snapshot store and the panel pipeline; the
embedding store waits for the query path).
"""

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
    "MANIFEST_NAME",
    "PanelPipeline",
    "SnapshotHandle",
    "SnapshotWriter",
    "StoreManifest",
    "TileCodec",
    "TileStore",
    "fetch_panel_encoded_info",
    "fetch_panel_info",
    "resolve_codec",
]
