"""Out-of-core graph snapshot store: dense adjacencies as grids of tiles.

Port of :mod:`repro.store.tilestore`, pure numpy, with the same on-disk
format: a JSON manifest (format version 1) and one ``.npy`` (raw, bf16) or
``.zst`` (zstd) file per tile, ``tile_RRRR_CCCC`` by grid position.  A store
the JAX package writes opens here, and a store written here opens there:
for a model-free system this store is the state carried across.

A :class:`TileStore` keeps each n x n snapshot as a ``grid x grid`` array of
dense tiles, backed by host RAM or by files on disk.  Devices never see a
whole snapshot: the streaming executors fetch one row panel at a time.

Durability: every tile is written to a temp file and ``os.replace``d into
place, and a snapshot id is appended to the manifest only by
:meth:`SnapshotWriter.commit` once all ``grid**2`` tiles exist, so a store
reopened after a crash holds only complete snapshots.

:class:`SnapshotHandle` stands in for a resident (n, n) adjacency wherever
the core accepts one; the core duck-types on its protocol (``shape`` /
``dtype`` / ``panel_rows`` / ``read_panel``), see
:func:`repro_torch.core.tiles.is_streamable`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator

import numpy as np

MANIFEST_NAME = "manifest.json"
_FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# tile codecs: encode-on-write, decode-on-read
# ---------------------------------------------------------------------------
#
# Decoding happens wherever ``read_tile`` runs -- for the streaming
# executors that is the PanelPipeline's prefetch thread, so decompression
# overlaps device compute.  The codec is part of the manifest fingerprint: a
# directory holds tiles of exactly one codec.


def _f32_to_bf16_u16(a: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 bit pattern (uint16), round-to-nearest-even.

    Pure numpy (the card's machine has no ``ml_dtypes``); bitwise equal to
    the JAX package's ``ml_dtypes`` cast for every finite input, including
    subnormals, ties and the largest values, which round to +-inf.  No NaN
    payloads are expected in adjacencies.
    """
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _bf16_u16_to_f32(u: np.ndarray) -> np.ndarray:
    """bf16 bit pattern (uint16) -> fp32 (exact widening)."""
    return (np.asarray(u, dtype=np.uint32) << 16).view(np.float32)


def _zstd_backend():
    """The installed zstd implementation, or None (optional dependency)."""
    try:
        import zstandard

        return zstandard
    except ImportError:
        pass
    try:
        import zstd

        return zstd
    except ImportError:
        return None


class TileCodec:
    """Storage encoding of one tile.  ``encode`` maps a logical-dtype block to
    its stored form (an ndarray for .npy-backed codecs, bytes for compressed
    ones); ``decode`` inverts it.  ``stored_nbytes`` is what the backing tier
    actually holds -- the pre-decode number the bytes-read counters report."""

    name: str
    suffix: str  # tile filename suffix (codec-specific: mixed dirs can't alias)
    # Whether the *stored* form can ship to the card and decode there (the
    # stream_gemm / fused_panel_matvec kernel path): true for raw (stored ==
    # decoded) and bf16 (uint16 bit patterns, widened in the kernel); false
    # for zstd (compressed byte streams decompress on the host).
    device_decodable = False

    def encode(self, block: np.ndarray):
        raise NotImplementedError

    def decode(self, stored, tile_rows: int, dtype: np.dtype) -> np.ndarray:
        raise NotImplementedError

    def stored_nbytes(self, stored) -> int:
        return len(stored) if isinstance(stored, (bytes, bytearray)) else stored.nbytes


class RawCodec(TileCodec):
    """Tiles stored verbatim (.npy, mmap-able).  Bitwise round-trip."""

    name, suffix = "raw", ".npy"
    device_decodable = True  # stored form IS the decoded form

    def encode(self, block: np.ndarray) -> np.ndarray:
        return block

    def decode(self, stored, tile_rows: int, dtype: np.dtype) -> np.ndarray:
        return np.asarray(stored)


class Bf16Codec(TileCodec):
    """fp32 tiles stored as bf16 bit patterns (uint16 .npy): half the bytes.

    Accuracy contract: decode(encode(x)) == bf16-round(x) -- a one-time
    relative error <= 2^-8 ~= 4e-3 applied at write time; everything computed
    *from* the stored tiles is exact with respect to the rounded values.
    float32 stores only: silently squeezing a wider dtype through an 8-bit
    mantissa would break the store's errors-loudly contract
    (:class:`TileStore` rejects the combination at construction)."""

    name, suffix = "bf16", ".npy"
    device_decodable = True  # uint16 bit patterns widen in-kernel

    def encode(self, block: np.ndarray) -> np.ndarray:
        return _f32_to_bf16_u16(block)

    def decode(self, stored, tile_rows: int, dtype: np.dtype) -> np.ndarray:
        u = np.asarray(stored)
        if u.dtype != np.uint16:
            raise ValueError(f"bf16 tile stored as {u.dtype}, want uint16")
        return _bf16_u16_to_f32(u).astype(dtype, copy=False)


class ZstdCodec(TileCodec):
    """Tiles zstd-compressed (lossless; raw C-order buffer per tile).

    The backend (``zstandard`` or ``zstd``) is an optional import --
    :func:`resolve_codec` falls back to ``raw`` with a warning when neither is
    installed, and opening an existing zstd store without a backend raises."""

    name, suffix = "zstd", ".zst"

    def __init__(self):
        self._z = _zstd_backend()
        if self._z is None:
            raise ImportError(
                "zstd codec requires the 'zstandard' (or 'zstd') package; "
                "install one or use codec='raw'/'bf16'"
            )
        # zstandard contexts are not safe under concurrent calls, and decode
        # runs in prefetch threads (two at once when a GEMM streams two
        # operands): one compressor/decompressor pair per thread.
        self._local = threading.local()

    def _ctxs(self):
        if not hasattr(self._local, "comp"):
            if hasattr(self._z, "ZstdCompressor"):  # zstandard
                self._local.comp = self._z.ZstdCompressor()
                self._local.decomp = self._z.ZstdDecompressor()
            else:  # the 'zstd' module is plain functions
                self._local.comp = self._local.decomp = None
        return self._local.comp, self._local.decomp

    def encode(self, block: np.ndarray) -> bytes:
        buf = np.ascontiguousarray(block).tobytes()
        comp, _ = self._ctxs()
        return comp.compress(buf) if comp is not None else self._z.compress(buf)

    def decode(self, stored, tile_rows: int, dtype: np.dtype) -> np.ndarray:
        _, decomp = self._ctxs()
        if decomp is not None:
            buf = decomp.decompress(bytes(stored))
        else:
            buf = self._z.decompress(bytes(stored))
        want = tile_rows * tile_rows * dtype.itemsize
        if len(buf) != want:
            raise ValueError(f"zstd tile decompressed to {len(buf)} bytes, want {want}")
        return np.frombuffer(buf, dtype=dtype).reshape(tile_rows, tile_rows)


CODECS = ("raw", "bf16", "zstd")


def resolve_codec(name: str, *, fallback: bool = True) -> TileCodec:
    """Codec instance for ``name``.

    ``fallback=True`` (writer path) degrades a backend-less ``zstd`` request
    to ``raw`` with a warning, so zstd-less environments run cleanly;
    ``fallback=False`` (reader path) raises instead -- an existing zstd store
    cannot be silently reinterpreted.
    """
    if name == "raw":
        return RawCodec()
    if name == "bf16":
        return Bf16Codec()
    if name == "zstd":
        try:
            return ZstdCodec()
        except ImportError:
            if not fallback:
                raise
            warnings.warn(
                "zstd backend not installed; falling back to codec='raw' "
                "(install 'zstandard' for compressed tiles)",
                stacklevel=3,
            )
            return RawCodec()
    raise ValueError(f"unknown tile codec {name!r}; want one of {CODECS}")


@dataclass
class StoreManifest:
    """Static geometry of every snapshot in the store + the committed order.

    ``meta`` is a caller-supplied content fingerprint (dataset name, seed,
    generator params ...).  Re-creating a store whose geometry matches but
    whose meta differs is rejected -- without it, a resumed write would
    silently skip committed ids and serve stale snapshots from a previous,
    differently-parameterized run.  ``codec`` names the storage encoding of
    every tile in the directory and is part of the same fingerprint: one
    store, one codec -- mixed-codec dirs error loudly.
    """

    n: int
    grid: int  # tiles per side; tile shape is (n/grid, n/grid)
    dtype: str
    codec: str = "raw"
    snapshots: list[str] = field(default_factory=list)
    meta: dict = field(default_factory=dict)
    version: int = _FORMAT_VERSION

    def __post_init__(self):
        if self.n < 1 or self.grid < 1:
            raise ValueError(f"need n >= 1 and grid >= 1, got n={self.n} grid={self.grid}")
        if self.n % self.grid:
            raise ValueError(f"grid {self.grid} must divide n={self.n}")

    @property
    def tile_rows(self) -> int:
        return self.n // self.grid

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self.version,
                "n": self.n,
                "grid": self.grid,
                "dtype": self.dtype,
                "codec": self.codec,
                "snapshots": list(self.snapshots),
                "meta": dict(self.meta),
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "StoreManifest":
        d = json.loads(text)
        if d.get("version", 0) > _FORMAT_VERSION:
            raise ValueError(f"store format v{d['version']} is newer than this reader")
        return cls(
            n=int(d["n"]),
            grid=int(d["grid"]),
            dtype=str(d["dtype"]),
            codec=str(d.get("codec", "raw")),  # pre-codec manifests are raw
            snapshots=[str(s) for s in d.get("snapshots", [])],
            meta=dict(d.get("meta", {})),
            version=int(d.get("version", _FORMAT_VERSION)),
        )


class TileStore:
    """A sequence of dense n x n snapshots, tiled grid x grid, RAM- or disk-backed.

    Use :meth:`create` / :meth:`open` rather than the constructor::

        store = TileStore.create(dir_or_none, n=1024, grid=8)
        store.put_snapshot("t000", a)                 # tile an in-memory array
        with store.writer("t001") as w:               # or tile-at-a-time
            for r, c in w.missing_tiles():
                w.put_tile(r, c, make_block(r, c))
        for snap in store.iter_snapshots():           # SnapshotHandles, in order
            det.push(snap)

    ``root=None`` selects the host-RAM backend (same API, dict of arrays) --
    useful for tests and for machines where host DRAM, not disk, is the
    capacity tier.
    """

    def __init__(self, manifest: StoreManifest, root: str | Path | None):
        self.manifest = manifest
        self.root = Path(root) if root is not None else None
        self._ram: dict[tuple[str, int, int], np.ndarray] = {}
        # Readers must not reinterpret existing tiles: no fallback here.
        self.codec = resolve_codec(manifest.codec, fallback=False)
        if self.codec.name == "bf16" and np.dtype(manifest.dtype) != np.float32:
            raise ValueError(
                f"bf16 codec stores float32 tiles only, not {manifest.dtype} "
                "(an 8-bit mantissa would silently destroy wider precision); "
                "use codec='raw' or 'zstd'"
            )

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(
        cls,
        root: str | Path | None,
        *,
        n: int,
        grid: int,
        dtype="float32",
        codec: str = "raw",
        meta: dict | None = None,
    ) -> "TileStore":
        """New store at ``root`` (made if missing); ``root=None`` = RAM-backed.

        ``meta`` fingerprints the content (dataset, seed, params).  Resuming
        an existing store requires matching geometry AND matching meta, so
        committed snapshots from a differently-parameterized run can't be
        silently served as this run's data.  ``codec`` selects the tile
        storage encoding (``raw`` / ``bf16`` / ``zstd``); it joins the
        geometry fingerprint, so resuming under a different codec errors
        rather than mixing encodings in one directory (a backend-less
        ``zstd`` request falls back to ``raw`` with a warning *before* the
        fingerprint is formed, so the manifest always records what the tiles
        actually are).
        """
        codec_name = resolve_codec(codec).name  # fallback resolves pre-fingerprint
        manifest = StoreManifest(
            n=n, grid=grid, dtype=np.dtype(dtype).name, codec=codec_name,
            meta=dict(meta or {}),
        )
        store = cls(manifest, root)
        if store.root is not None:
            store.root.mkdir(parents=True, exist_ok=True)
            existing = store.root / MANIFEST_NAME
            if existing.exists():
                old = StoreManifest.from_json(existing.read_text())
                if (old.n, old.grid, old.dtype, old.codec) != (
                    n, grid, manifest.dtype, codec_name,
                ):
                    raise ValueError(
                        f"store at {root} already exists with incompatible geometry "
                        f"(n={old.n} grid={old.grid} dtype={old.dtype} "
                        f"codec={old.codec}, requested codec={codec_name})"
                    )
                if meta is not None and old.meta != manifest.meta:
                    # Adopting a meta is only safe while nothing is committed:
                    # an unlabeled store with snapshots could be anything, and
                    # resuming it under a fresh label would serve stale data.
                    if old.meta or old.snapshots:
                        raise ValueError(
                            f"store at {root} holds different content: manifest meta "
                            f"{old.meta or '<unlabeled, has snapshots>'} != requested "
                            f"{manifest.meta}; use a fresh directory (or delete the "
                            "stale store)"
                        )
                store.manifest = old  # resume: keep committed snapshots
                if meta is not None and old.meta != manifest.meta:
                    store.manifest.meta = manifest.meta
                    store._write_manifest()
            else:
                store._write_manifest()
        return store

    @classmethod
    def open(cls, root: str | Path) -> "TileStore":
        root = Path(root)
        manifest = StoreManifest.from_json((root / MANIFEST_NAME).read_text())
        return cls(manifest, root)

    def _write_manifest(self) -> None:
        if self.root is None:
            return
        tmp = self.root / (MANIFEST_NAME + ".tmp")
        tmp.write_text(self.manifest.to_json())
        os.replace(tmp, self.root / MANIFEST_NAME)

    def _refresh_manifest(self) -> None:
        """Re-read the on-disk snapshot list before a manifest mutation.

        Several TileStore instances may share one directory over time (e.g.
        each out-of-core chain build opens the scratch dir anew while earlier
        builds' operators are still live); mutations must read-modify-write
        the current file state or a stale instance would clobber snapshots
        committed after it opened.
        """
        if self.root is None:
            return
        path = self.root / MANIFEST_NAME
        if path.exists():
            self.manifest.snapshots = StoreManifest.from_json(path.read_text()).snapshots

    # -- geometry ------------------------------------------------------------

    @property
    def n(self) -> int:
        return self.manifest.n

    @property
    def grid(self) -> int:
        return self.manifest.grid

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.manifest.dtype)

    @property
    def tile_rows(self) -> int:
        return self.manifest.tile_rows

    @property
    def snapshot_nbytes(self) -> int:
        return self.n * self.n * self.dtype.itemsize

    @property
    def snapshot_ids(self) -> list[str]:
        return list(self.manifest.snapshots)

    def __len__(self) -> int:
        return len(self.manifest.snapshots)

    # -- tile I/O ------------------------------------------------------------

    def _tile_path(self, snap_id: str, r: int, c: int) -> Path:
        assert self.root is not None
        return self.root / snap_id / f"tile_{r:04d}_{c:04d}{self.codec.suffix}"

    def has_tile(self, snap_id: str, r: int, c: int) -> bool:
        if self.root is None:
            return (snap_id, r, c) in self._ram
        return self._tile_path(snap_id, r, c).exists()

    def _load_stored(self, snap_id: str, r: int, c: int, *, mmap: bool = True):
        """The stored (encoded) form of one tile: ndarray or bytes."""
        if self.root is None:
            return self._ram[(snap_id, r, c)]
        path = self._tile_path(snap_id, r, c)
        if self.codec.suffix == ".npy":
            return np.load(path, mmap_mode="r" if mmap else None)
        return path.read_bytes()

    def read_tile(self, snap_id: str, r: int, c: int, *, mmap: bool = True) -> np.ndarray:
        """One (tile_rows, tile_rows) dense *decoded* tile.

        Disk tiles of .npy-backed codecs are memmapped before decode; decode
        runs wherever the caller runs -- the streaming executors call this
        from the PanelPipeline prefetch thread, so decompression overlaps
        device compute.
        """
        g = self.grid
        if not (0 <= r < g and 0 <= c < g):
            raise IndexError(f"tile ({r}, {c}) outside {g}x{g} grid")
        tr = self.tile_rows
        arr = self.codec.decode(
            self._load_stored(snap_id, r, c, mmap=mmap), tr, self.dtype
        )
        if arr.shape != (tr, tr) or arr.dtype != self.dtype:
            raise ValueError(
                f"tile ({r}, {c}) of {snap_id!r} decodes to {arr.shape}/{arr.dtype}, "
                f"manifest says ({tr}, {tr})/{self.dtype}"
            )
        return arr

    def read_tile_stored(self, snap_id: str, r: int, c: int) -> np.ndarray:
        """One tile in its *stored* (encoded) form, for on-device decode.

        Only meaningful for device-decodable codecs (raw: the fp32 tile
        itself; bf16: the (tile_rows, tile_rows) uint16 bit-pattern array the
        stream_gemm kernel widens).  Compressed codecs raise.
        """
        if not getattr(self.codec, "device_decodable", False):
            raise ValueError(
                f"codec {self.codec.name!r} has no device-decodable stored form; "
                "read_tile decodes on the host instead"
            )
        g = self.grid
        if not (0 <= r < g and 0 <= c < g):
            raise IndexError(f"tile ({r}, {c}) outside {g}x{g} grid")
        arr = np.asarray(self._load_stored(snap_id, r, c))
        tr = self.tile_rows
        if arr.shape != (tr, tr):
            raise ValueError(
                f"tile ({r}, {c}) of {snap_id!r} stored as {arr.shape}, "
                f"manifest says ({tr}, {tr})"
            )
        return arr

    def tile_nbytes_stored(self, snap_id: str, r: int, c: int) -> int:
        """Bytes the backing tier holds for one tile (pre-decode)."""
        if self.root is None:
            return self.codec.stored_nbytes(self._ram[(snap_id, r, c)])
        path = self._tile_path(snap_id, r, c)
        # .npy files carry a small header; the payload size is what matters
        # for bandwidth accounting, so use the file size as-is.
        return path.stat().st_size

    def _store_tile(self, snap_id: str, r: int, c: int, block: np.ndarray) -> None:
        tr = self.tile_rows
        block = np.ascontiguousarray(np.asarray(block, dtype=self.dtype))
        if block.shape != (tr, tr):
            raise ValueError(f"tile ({r}, {c}) has shape {block.shape}, want ({tr}, {tr})")
        stored = self.codec.encode(block)
        if self.root is None:
            # Always copy ndarray-encoded tiles: raw encode passes the caller's
            # array through, and a stored view would track later caller
            # mutation instead of the put-time snapshot.
            self._ram[(snap_id, r, c)] = (
                stored if isinstance(stored, bytes) else np.array(stored, copy=True)
            )
            return
        path = self._tile_path(snap_id, r, c)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            if isinstance(stored, bytes):
                f.write(stored)
            else:
                np.save(f, stored)
        os.replace(tmp, path)  # atomic: a crash leaves either old or new, never torn

    # -- writers -------------------------------------------------------------

    def writer(self, snap_id: str) -> "SnapshotWriter":
        if "/" in snap_id or snap_id in ("", ".", ".."):
            raise ValueError(f"bad snapshot id {snap_id!r}")
        return SnapshotWriter(self, snap_id)

    def put_snapshot(self, snap_id: str, a) -> "SnapshotHandle":
        """Tile an in-memory (n, n) array into the store and commit it."""
        a = np.asarray(a)
        if a.shape != (self.n, self.n):
            raise ValueError(f"snapshot is {a.shape}, store holds ({self.n}, {self.n})")
        tr = self.tile_rows
        with self.writer(snap_id) as w:
            for r, c in w.missing_tiles():
                w.put_tile(r, c, a[r * tr : (r + 1) * tr, c * tr : (c + 1) * tr])
        return self.snapshot(snap_id)

    def put_snapshot_tiles(
        self, snap_id: str, tile_fn: Callable[[np.ndarray, np.ndarray], np.ndarray]
    ) -> "SnapshotHandle":
        """Out-of-core write: ``tile_fn(global_rows, global_cols) -> block``.

        The n x n snapshot is never materialized -- each tile is produced and
        written independently, so arbitrarily large graphs can be laid down
        from a (small) node-feature table.  Already-present tiles are skipped
        (resume after a partial write).
        """
        tr = self.tile_rows
        with self.writer(snap_id) as w:
            for r, c in w.missing_tiles():
                rows = np.arange(r * tr, (r + 1) * tr)
                cols = np.arange(c * tr, (c + 1) * tr)
                w.put_tile(r, c, tile_fn(rows, cols))
        return self.snapshot(snap_id)

    def _commit(self, snap_id: str) -> None:
        self._refresh_manifest()
        if snap_id not in self.manifest.snapshots:
            self.manifest.snapshots.append(snap_id)
            self._write_manifest()

    def remove_snapshot(self, snap_id: str) -> None:
        """Drop a snapshot's tiles (and its manifest entry, if committed).

        This is how out-of-core *working* matrices (the chain's S / T / P
        intermediates) are retired as soon as the recurrence no longer needs
        them, bounding scratch capacity by the live working set.  Removing an
        uncommitted (partially written) snapshot is allowed and cleans up its
        tiles.  The manifest entry goes first, the tiles second: a crash in
        between leaves only harmless orphan tiles, never a committed id whose
        tiles are gone (the "committed == complete" invariant).
        """
        if "/" in snap_id or snap_id in ("", ".", ".."):
            raise ValueError(f"bad snapshot id {snap_id!r}")
        self._refresh_manifest()
        if snap_id in self.manifest.snapshots:
            self.manifest.snapshots.remove(snap_id)
            self._write_manifest()
        if self.root is None:
            for key in [k for k in self._ram if k[0] == snap_id]:
                del self._ram[key]
        else:
            snap_dir = self.root / snap_id
            if snap_dir.exists():
                shutil.rmtree(snap_dir)

    # -- readers -------------------------------------------------------------

    def snapshot(self, snap_id: str) -> "SnapshotHandle":
        if snap_id not in self.manifest.snapshots:
            raise KeyError(f"snapshot {snap_id!r} not committed; have {self.manifest.snapshots}")
        return SnapshotHandle(self, snap_id)

    def iter_snapshots(self) -> Iterator["SnapshotHandle"]:
        """Handles in committed (sequence) order -- feed to SequenceDetector.run."""
        for sid in self.manifest.snapshots:
            yield SnapshotHandle(self, sid)


class SnapshotWriter:
    """Tile-at-a-time writer with commit-on-complete (context manager).

    ``missing_tiles()`` drives resumable writes: after a crash mid-snapshot,
    re-running the same writer recomputes only the absent tiles.  ``commit()``
    (called on clean ``with``-exit) appends the id to the manifest once every
    tile is present, and raises if any are still missing.
    """

    def __init__(self, store: TileStore, snap_id: str):
        self.store = store
        self.snap_id = snap_id

    def missing_tiles(self) -> list[tuple[int, int]]:
        g = self.store.grid
        return [
            (r, c)
            for r in range(g)
            for c in range(g)
            if not self.store.has_tile(self.snap_id, r, c)
        ]

    def put_tile(self, r: int, c: int, block: np.ndarray) -> None:
        self.store._store_tile(self.snap_id, r, c, block)

    def put_row_panel(self, row0: int, panel: np.ndarray) -> None:
        """Write a full-width (height, n) row panel as its constituent tiles.

        The streaming producers (out-of-core chain GEMMs, panel transforms)
        emit full-width row panels; this slices them back into the store's
        tile grid.  ``row0`` and the panel height must be tile-aligned.
        """
        tr = self.store.tile_rows
        n = self.store.n
        panel = np.asarray(panel)
        if panel.ndim != 2 or panel.shape[1] != n:
            raise ValueError(f"row panel must be (height, {n}), got {panel.shape}")
        if row0 % tr or panel.shape[0] % tr:
            raise ValueError(
                f"panel [{row0}:{row0 + panel.shape[0]}] not tile-aligned (tile={tr})"
            )
        r_lo = row0 // tr
        for i in range(panel.shape[0] // tr):
            for c in range(self.store.grid):
                self.put_tile(
                    r_lo + i, c, panel[i * tr : (i + 1) * tr, c * tr : (c + 1) * tr]
                )

    def commit(self) -> None:
        missing = self.missing_tiles()
        if missing:
            raise ValueError(
                f"snapshot {self.snap_id!r} incomplete: {len(missing)} tiles missing "
                f"(first: {missing[0]})"
            )
        self.store._commit(self.snap_id)

    def __enter__(self) -> "SnapshotWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.commit()


@dataclass(frozen=True)
class SnapshotHandle:
    """Store-backed stand-in for a resident (n, n) adjacency tensor.

    Satisfies the streaming protocol the core duck-types on
    (:func:`repro_torch.core.tiles.is_streamable`): ``shape``, ``dtype``,
    ``panel_rows`` and ``read_panel``.  Panels are assembled on the host from
    the snapshot's tile row (memmap reads), bounded by one panel of host RAM.
    """

    store: TileStore
    snap_id: str

    @property
    def shape(self) -> tuple[int, int]:
        return (self.store.n, self.store.n)

    @property
    def dtype(self) -> np.dtype:
        return self.store.dtype

    @property
    def nbytes(self) -> int:
        return self.store.snapshot_nbytes

    @property
    def panel_rows(self) -> int:
        """Preferred streaming unit: one tile row (full-width panel)."""
        return self.store.tile_rows

    def read_panel(self, row0: int, height: int) -> np.ndarray:
        """The (height, n) row panel starting at global row ``row0``."""
        tr = self.store.tile_rows
        if row0 % tr or height % tr:
            raise ValueError(f"panel [{row0}:{row0 + height}] not tile-aligned (tile={tr})")
        r_lo, r_hi = row0 // tr, (row0 + height) // tr
        g = self.store.grid
        rows = [
            np.concatenate(
                [self.store.read_tile(self.snap_id, r, c) for c in range(g)], axis=1
            )
            if g > 1
            else np.asarray(self.store.read_tile(self.snap_id, r, 0))
            for r in range(r_lo, r_hi)
        ]
        return rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)

    def read_panel_info(self, row0: int, height: int) -> tuple[np.ndarray, int]:
        """``(panel, stored_nbytes)``: the decoded panel plus the pre-decode
        bytes the backing tier served for it -- the pair the streaming
        pipeline's bytes-read / bytes-decoded counters are built from."""
        panel = self.read_panel(row0, height)
        tr = self.store.tile_rows
        g = self.store.grid
        stored = sum(
            self.store.tile_nbytes_stored(self.snap_id, r, c)
            for r in range(row0 // tr, (row0 + height) // tr)
            for c in range(g)
        )
        return panel, stored

    def read_panel_encoded_info(
        self, row0: int, height: int
    ) -> tuple[np.ndarray, int, int]:
        """``(panel, stored_nbytes, decoded_nbytes)`` with the panel in a
        *device-decodable stored form* (the stream_gemm kernel path).

        For the bf16 codec the panel is the raw uint16 bit patterns -- half
        the decoded bytes; the H2D transfer ships the stored width and the
        kernel widens.  Codecs whose stored form is already decoded
        (raw) or not device-decodable at all (zstd) fall back to the decoded
        read, with ``decoded_nbytes == panel.nbytes`` (nothing saved).
        """
        store = self.store
        if store.codec.name != "bf16":
            panel, stored = self.read_panel_info(row0, height)
            return panel, stored, panel.nbytes
        tr = store.tile_rows
        if row0 % tr or height % tr:
            raise ValueError(
                f"panel [{row0}:{row0 + height}] not tile-aligned (tile={tr})"
            )
        r_lo, r_hi = row0 // tr, (row0 + height) // tr
        g = store.grid
        rows = [
            np.concatenate(
                [store.read_tile_stored(self.snap_id, r, c) for c in range(g)], axis=1
            )
            if g > 1
            else np.asarray(store.read_tile_stored(self.snap_id, r, 0))
            for r in range(r_lo, r_hi)
        ]
        panel = rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)
        stored = sum(
            store.tile_nbytes_stored(self.snap_id, r, c)
            for r in range(r_lo, r_hi)
            for c in range(g)
        )
        decoded = panel.size * store.dtype.itemsize  # what a host decode would ship
        return panel, stored, decoded

    def to_numpy(self) -> np.ndarray:
        """Gather the whole snapshot (tests / small graphs only)."""
        return np.asarray(self.read_panel(0, self.store.n))
