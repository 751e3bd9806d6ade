"""Persisted commute-embedding artifacts: the query read path's store.

Port of :mod:`repro.store.embstore`, pure numpy, with the same on-disk
format: a JSON manifest of ``kind: embstore`` (format version 1), one
``z_PPPP.npy`` row panel per ``panel_rows`` rows of the (n, k) sketch ``Z``
(raw fp32, or bf16 bit patterns as uint16), and an ``aux.npz`` sidecar with
``vol`` / ``deg`` / ``zbar``.  An artifact the JAX package writes opens here,
and one written here opens there.

``SequenceDetector.push`` publishes here after each embedding, so the query
path (:mod:`repro_torch.core.query`) never touches live solver state.  The
store keeps the snapshot store's durability rules:

* every panel and the sidecar are written to a temp file and
  ``os.replace``d into place;
* an embedding id joins the manifest only once all its panels and the
  sidecar exist (commit-on-complete), and ``put_embedding`` over a torn
  publish skips the panels already written (resume);
* the manifest is fingerprinted on (n, k, panel_rows, dtype, codec, seed)
  plus the caller's ``meta``: re-creating a store under other parameters
  raises instead of serving a sketch drawn from another projection;
* codecs are ``raw`` and ``bf16`` only -- the forms the query kernel
  decodes on the card.

:class:`EmbeddingHandle` speaks the panel protocol (``shape`` / ``dtype`` /
``panel_rows`` / ``read_panel`` / ``read_panel_info`` /
``read_panel_encoded_info``), so :class:`~repro_torch.store.PanelPipeline`
streams ``Z`` exactly as it streams a snapshot.
"""

from __future__ import annotations

import io
import json
import mmap
import os
import resource
import shutil
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np

from repro_torch.store.tilestore import MANIFEST_NAME, resolve_codec

_FORMAT_VERSION = 1
_AUX_NAME = "aux.npz"

# Codecs with a device-decodable stored form only: the query kernel takes
# panels in stored form (bf16 bits widen in the kernel), which zstd is not.
EMB_CODECS = ("raw", "bf16")


# .npy header bytes -> (dtype, shape, data offset, element count).  Every
# panel of an artifact has the same header, so it is parsed once.  A query
# reads one small file per panel, and there the file system's per-call
# latency is most of the host time: np.load with mmap makes some ten calls
# and parses the header each time, and even one read call per panel is most
# of a query where each call is a round trip; a handle copies its panels
# out of maps of the files that the store keeps (``_PanelMaps``).
_NPY_HEADERS: dict[bytes, tuple[np.dtype, tuple, int, int]] = {}


def _maps_limit() -> int:
    """How many panel files one store keeps mapped: each map holds a file
    descriptor, so half the soft RLIMIT_NOFILE, and at most 32768 (the
    kernel's default limit on a process's maps is 65530)."""
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    return 32768 if soft == resource.RLIM_INFINITY else max(0, min(soft // 2, 32768))


class _PanelMaps:
    """The kept maps of one artifact's panel files, made under one sidecar.

    A committed panel never changes in place: a rewrite is a new file put in
    place with os.replace, and a re-published artifact writes its sidecar
    last.  The set holds that sidecar open, so no later sidecar can take its
    inode number; a handle compares the sidecar's inode once, at its first
    panel read, and maps the artifact anew when another store or process has
    published it since.
    """

    def __init__(self, aux_fd: int, ident: tuple[int, int]):
        self.aux_fd, self.ident = aux_fd, ident
        self.maps: dict[int, mmap.mmap] = {}
        self.closed = False

    def close(self) -> None:
        for mm in self.maps.values():
            mm.close()
        self.maps.clear()
        os.close(self.aux_fd)
        self.closed = True

    def __del__(self):
        if not self.closed:
            self.close()


def _npy_meta(buf: bytes):
    """The cached header of a C-order .npy image, or None (short or unusual)."""
    if len(buf) < 12 or buf[:6] != b"\x93NUMPY":
        return None
    # version (2 bytes), then the little-endian header length: 2 bytes in v1, 4 after
    off = 10 + int.from_bytes(buf[8:10], "little") if buf[6] == 1 else \
        12 + int.from_bytes(buf[8:12], "little")
    if len(buf) < off:
        return None
    meta = _NPY_HEADERS.get(buf[:off])
    if meta is None:
        f = io.BytesIO(buf[:off])
        version = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if version == (1, 0) else \
            np.lib.format.read_array_header_2_0
        shape, fortran, dtype = read(f)
        if fortran or f.tell() != off:
            return None
        meta = _NPY_HEADERS.setdefault(buf[:off], (dtype, shape, off, int(np.prod(shape))))
    return meta


def _read_npy(path: Path, size_hint: int) -> tuple[np.ndarray, int]:
    """A .npy file as a read-only array, and its size in bytes; ``size_hint``
    bytes are read in one call, the rest of a longer file after it."""
    fd = os.open(path, os.O_RDONLY)
    try:
        buf = os.read(fd, size_hint)
        meta = _npy_meta(buf)
        if meta is None or len(buf) < meta[2] + meta[0].itemsize * meta[3]:
            while more := os.read(fd, 1 << 20):
                buf += more
    finally:
        os.close(fd)
    return _npy_array(buf)


def _npy_array(buf: bytes) -> tuple[np.ndarray, int]:
    """A whole .npy file image as a read-only array, and its size in bytes."""
    meta = _npy_meta(buf)
    if meta is None:  # a Fortran-order or otherwise unusual file: numpy's reader
        return np.load(io.BytesIO(buf)), len(buf)
    dtype, shape, off, count = meta
    return np.frombuffer(buf, dtype, count=count, offset=off).reshape(shape), len(buf)


def _host(x) -> np.ndarray:
    """A host numpy view of an array or a (possibly CUDA) tensor."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def fit(dim: int, want: int) -> int:
    """The largest divisor of ``dim`` that is <= ``want``, preferring multiples
    of 128, then of 8, then any (a copy of ``repro.kernels.tiling.fit``: it
    sets an artifact's panel count, so both packages must agree on it)."""
    want = min(want, dim)
    for align in (128, 8, 1):
        t = (want // align) * align
        while t >= align:
            if dim % t == 0:
                return t
            t -= align
    return 1


def default_panel_rows(n: int, want: int = 256) -> int:
    """The artifact's default panel height: ``fit(n, want)`` (144 at n=10512)."""
    return fit(n, want)


@dataclass
class EmbManifest:
    """Static geometry + provenance fingerprint of every embedding artifact."""

    n: int
    k: int
    panel_rows: int
    dtype: str
    codec: str = "raw"
    seed: int = 0
    embeddings: list[str] = field(default_factory=list)
    meta: dict = field(default_factory=dict)
    version: int = _FORMAT_VERSION

    def __post_init__(self):
        if self.n < 1 or self.k < 1:
            raise ValueError(f"need n >= 1 and k >= 1, got n={self.n} k={self.k}")
        if self.panel_rows < 1 or self.n % self.panel_rows:
            raise ValueError(f"panel_rows {self.panel_rows} must divide n={self.n}")

    @property
    def panels(self) -> int:
        return self.n // self.panel_rows

    def fingerprint(self) -> tuple:
        return (self.n, self.k, self.panel_rows, self.dtype, self.codec, self.seed)

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": self.version,
                "kind": "embstore",
                "n": self.n,
                "k": self.k,
                "panel_rows": self.panel_rows,
                "dtype": self.dtype,
                "codec": self.codec,
                "seed": self.seed,
                "embeddings": list(self.embeddings),
                "meta": dict(self.meta),
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "EmbManifest":
        d = json.loads(text)
        if d.get("kind") != "embstore":
            raise ValueError(
                f"manifest kind {d.get('kind')!r} is not an embedding store "
                "(a TileStore directory cannot be opened as an EmbeddingStore)"
            )
        if d.get("version", 0) > _FORMAT_VERSION:
            raise ValueError(f"embstore format v{d['version']} is newer than this reader")
        return cls(
            n=int(d["n"]),
            k=int(d["k"]),
            panel_rows=int(d["panel_rows"]),
            dtype=str(d["dtype"]),
            codec=str(d.get("codec", "raw")),
            seed=int(d.get("seed", 0)),
            embeddings=[str(s) for s in d.get("embeddings", [])],
            meta=dict(d.get("meta", {})),
            version=int(d.get("version", _FORMAT_VERSION)),
        )


def _check_id(emb_id: str) -> None:
    if "/" in emb_id or emb_id in ("", ".", ".."):
        raise ValueError(f"bad embedding id {emb_id!r}")


class EmbeddingStore:
    """A sequence of committed (Z, vol, deg, zbar) embedding artifacts.

    Use :meth:`create` / :meth:`open` rather than the constructor::

        store = EmbeddingStore.create(dir_or_none, n=10512, k=17, seed=0)
        store.put_embedding("t0003", z, vol, deg)     # publish one artifact
        h = store.latest()                            # EmbeddingHandle

    ``root=None`` selects the host-RAM backend (same API, dict of arrays).
    """

    def __init__(self, manifest: EmbManifest, root: str | Path | None):
        if manifest.codec not in EMB_CODECS:
            raise ValueError(
                f"embedding store codec must be one of {EMB_CODECS}, got "
                f"{manifest.codec!r} (the query kernel needs a device-"
                "decodable stored form)"
            )
        self.manifest = manifest
        self.root = Path(root) if root is not None else None
        self._ram_panels: dict[tuple[str, int], np.ndarray] = {}
        self._ram_aux: dict[str, dict[str, np.ndarray]] = {}
        # kept panel maps per artifact, the most recently opened last
        self._maps: OrderedDict[str, _PanelMaps] = OrderedDict()
        self._maps_lock = threading.Lock()
        self._n_maps = 0
        self.maps_limit = _maps_limit()
        self.codec = resolve_codec(manifest.codec, fallback=False)
        if self.codec.name == "bf16" and np.dtype(manifest.dtype) != np.float32:
            raise ValueError(f"bf16 codec stores float32 embeddings only, not {manifest.dtype}")

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(
        cls,
        root: str | Path | None,
        *,
        n: int,
        k: int,
        panel_rows: int | None = None,
        dtype="float32",
        codec: str = "raw",
        seed: int = 0,
        meta: dict | None = None,
    ) -> "EmbeddingStore":
        """New store at ``root`` (made if missing); ``root=None`` = RAM-backed.

        Resuming an existing directory requires a matching fingerprint and,
        when ``meta`` is given, matching meta.
        """
        pr = default_panel_rows(n) if panel_rows is None else int(panel_rows)
        manifest = EmbManifest(
            n=n, k=k, panel_rows=pr, dtype=np.dtype(dtype).name,
            codec=resolve_codec(codec).name, seed=int(seed), meta=dict(meta or {}),
        )
        store = cls(manifest, root)
        if store.root is None:
            return store
        store.root.mkdir(parents=True, exist_ok=True)
        existing = store.root / MANIFEST_NAME
        if not existing.exists():
            store._write_manifest()
            return store
        old = EmbManifest.from_json(existing.read_text())
        if old.fingerprint() != manifest.fingerprint():
            raise ValueError(
                f"embedding store at {root} already exists with an "
                f"incompatible fingerprint {old.fingerprint()} != "
                f"requested {manifest.fingerprint()} "
                "(n, k, panel_rows, dtype, codec, seed); use a fresh "
                "directory -- a differently-seeded sketch is a "
                "different random projection"
            )
        relabel = meta is not None and old.meta != manifest.meta
        if relabel and (old.meta or old.embeddings):
            raise ValueError(
                f"embedding store at {root} holds different content: "
                f"meta {old.meta or '<unlabeled, has embeddings>'} != "
                f"requested {manifest.meta}; use a fresh directory"
            )
        store.manifest = old  # resume: keep committed embeddings
        if relabel:
            store.manifest.meta = manifest.meta
            store._write_manifest()
        return store

    @classmethod
    def open(cls, root: str | Path) -> "EmbeddingStore":
        root = Path(root)
        return cls(EmbManifest.from_json((root / MANIFEST_NAME).read_text()), root)

    def _write_manifest(self) -> None:
        if self.root is None:
            return
        tmp = self.root / (MANIFEST_NAME + ".tmp")
        tmp.write_text(self.manifest.to_json())
        os.replace(tmp, self.root / MANIFEST_NAME)

    def _refresh_manifest(self) -> None:
        """Re-read the committed list before mutating it (several instances
        may share one directory over a run's lifetime)."""
        if self.root is None:
            return
        path = self.root / MANIFEST_NAME
        if path.exists():
            self.manifest.embeddings = EmbManifest.from_json(path.read_text()).embeddings

    # -- geometry ------------------------------------------------------------

    @property
    def n(self) -> int:
        return self.manifest.n

    @property
    def k(self) -> int:
        return self.manifest.k

    @property
    def panel_rows(self) -> int:
        return self.manifest.panel_rows

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(self.manifest.dtype)

    @property
    def embedding_ids(self) -> list[str]:
        return list(self.manifest.embeddings)

    def __len__(self) -> int:
        return len(self.manifest.embeddings)

    # -- panel I/O -----------------------------------------------------------

    def _panel_path(self, emb_id: str, p: int) -> Path:
        return self.root / emb_id / f"z_{p:04d}{self.codec.suffix}"

    def _aux_path(self, emb_id: str) -> Path:
        return self.root / emb_id / _AUX_NAME

    def has_panel(self, emb_id: str, p: int) -> bool:
        if self.root is None:
            return (emb_id, p) in self._ram_panels
        return self._panel_path(emb_id, p).exists()

    def has_aux(self, emb_id: str) -> bool:
        if self.root is None:
            return emb_id in self._ram_aux
        return self._aux_path(emb_id).exists()

    def read_panel_stored_info(self, emb_id: str, p: int,
                               maps: _PanelMaps | None = None) -> tuple[np.ndarray, int]:
        """One (panel_rows, k) panel in its stored form (raw fp32 or uint16
        bf16 bit patterns -- what the query kernel decodes on the card) and
        the bytes the backing tier served for it; copied out of ``maps``
        (a handle's, :meth:`_open_maps`) where the panel is or can be kept
        mapped, else read from its file."""
        if not 0 <= p < self.manifest.panels:
            raise IndexError(f"panel {p} outside {self.manifest.panels} panels")
        if self.root is None:
            arr = self._ram_panels[(emb_id, p)]
            nbytes = self.codec.stored_nbytes(arr)
        else:
            path = self._panel_path(emb_id, p)
            buf = None if maps is None else self._copy_mapped(maps, path, p)
            if buf is None:
                hint = self.panel_rows * self.k * self.dtype.itemsize + 4096  # data + any header
                arr, nbytes = _read_npy(path, hint)
            else:
                arr, nbytes = _npy_array(buf)
        want = (self.panel_rows, self.k)
        if arr.shape != want:
            raise ValueError(f"panel {p} of {emb_id!r} stored as {arr.shape}, manifest says {want}")
        return arr, nbytes

    def _open_maps(self, emb_id: str) -> _PanelMaps:
        """The kept maps of ``emb_id``, checked against its sidecar's inode
        (one open and one fstat); a set made under another sidecar is closed."""
        fd = os.open(self._aux_path(emb_id), os.O_RDONLY)
        st = os.fstat(fd)
        ident = (st.st_dev, st.st_ino)
        with self._maps_lock:
            pm = self._maps.pop(emb_id, None)
            if pm is not None and pm.ident == ident:
                os.close(fd)
            else:
                if pm is not None:
                    self._close_maps(pm)
                pm = _PanelMaps(fd, ident)
            self._maps[emb_id] = pm
        return pm

    def _close_maps(self, pm: _PanelMaps) -> None:
        self._n_maps -= len(pm.maps)
        pm.close()

    def _copy_mapped(self, pm: _PanelMaps, path: Path, p: int) -> bytes | None:
        """Panel ``p``'s file image copied out of its kept map, mapped now if
        need be; None once ``pm`` was closed or when the store keeps
        ``maps_limit`` maps of this artifact (the read then opens the file).
        Other artifacts' maps, least recently opened first, make room."""
        with self._maps_lock:
            if pm.closed:
                return None
            mm = pm.maps.get(p)
            if mm is None:
                while self._n_maps >= self.maps_limit:
                    victim = next((k for k, v in self._maps.items() if v is not pm), None)
                    if victim is None:
                        return None
                    self._close_maps(self._maps.pop(victim))
                fd = os.open(path, os.O_RDONLY)
                try:
                    mm = pm.maps[p] = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
                finally:
                    os.close(fd)
                self._n_maps += 1
            return mm[:]  # a copy: no view outlives the map

    def read_panel_stored(self, emb_id: str, p: int) -> np.ndarray:
        return self.read_panel_stored_info(emb_id, p)[0]

    def decode(self, stored: np.ndarray) -> np.ndarray:
        """A stored-form panel as dense (panel_rows, k) values."""
        arr = self.codec.decode(stored, self.panel_rows, self.dtype)
        return np.asarray(arr).reshape(self.panel_rows, self.k)

    def read_panel(self, emb_id: str, p: int) -> np.ndarray:
        """One (panel_rows, k) dense decoded panel."""
        return self.decode(self.read_panel_stored(emb_id, p))

    def panel_nbytes_stored(self, emb_id: str, p: int) -> int:
        if self.root is None:
            return self.codec.stored_nbytes(self._ram_panels[(emb_id, p)])
        return self._panel_path(emb_id, p).stat().st_size

    def read_aux(self, emb_id: str) -> dict[str, np.ndarray]:
        """``{vol: (), deg: (n,), zbar: (k,)}`` -- the small sidecar."""
        if self.root is None:
            aux = self._ram_aux[emb_id]
        else:
            with np.load(self._aux_path(emb_id)) as z:
                aux = {name: np.asarray(z[name]) for name in z.files}
        for name in ("vol", "deg", "zbar"):
            if name not in aux:
                raise ValueError(f"aux sidecar of {emb_id!r} is missing {name!r}")
        return aux

    # -- write path ----------------------------------------------------------

    def put_embedding(self, emb_id: str, z, vol, deg, *, zbar=None) -> "EmbeddingHandle":
        """Persist one committed embedding artifact and commit it.

        ``z`` is the (n, k) sketch (a numpy array or a tensor on any device;
        copied to the host, so readers never alias live device buffers),
        ``vol`` the scalar graph volume, ``deg`` the (n,) degree vector.
        ``zbar`` (Z's column mean) is computed here in float64 unless given.
        Panels already written are skipped (resume); the id joins the
        manifest only once every panel and the sidecar exist.
        """
        _check_id(emb_id)
        z = np.ascontiguousarray(_host(z), dtype=self.dtype)
        if z.shape != (self.n, self.k):
            raise ValueError(f"embedding is {z.shape}, store holds ({self.n}, {self.k})")
        deg = np.asarray(_host(deg), dtype=np.float32).reshape(-1)
        if deg.shape != (self.n,):
            raise ValueError(f"deg is {deg.shape}, want ({self.n},)")
        zbar = (
            z.mean(axis=0, dtype=np.float64).astype(np.float32)
            if zbar is None
            else np.asarray(_host(zbar), dtype=np.float32).reshape(self.k)
        )
        aux = {"vol": np.asarray(float(_host(vol)), dtype=np.float64), "deg": deg, "zbar": zbar}
        pr = self.panel_rows
        for p in range(self.manifest.panels):
            if not self.has_panel(emb_id, p):  # resume after a partial publish
                self._store_panel(emb_id, p, np.asarray(self.codec.encode(z[p * pr : (p + 1) * pr])))
        self._store_aux(emb_id, aux)
        self._commit(emb_id)
        return self.embedding(emb_id)

    def _write_atomic(self, path: Path, save) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            save(f)
        os.replace(tmp, path)  # atomic: old or new, never torn

    def _store_panel(self, emb_id: str, p: int, stored: np.ndarray) -> None:
        if self.root is None:
            self._ram_panels[(emb_id, p)] = np.array(stored, copy=True)
        else:
            self._write_atomic(self._panel_path(emb_id, p), lambda f: np.save(f, stored))

    def _store_aux(self, emb_id: str, aux: dict[str, np.ndarray]) -> None:
        if self.root is None:
            self._ram_aux[emb_id] = {k: np.array(v, copy=True) for k, v in aux.items()}
        else:
            self._write_atomic(self._aux_path(emb_id), lambda f: np.savez(f, **aux))

    def _commit(self, emb_id: str) -> None:
        missing = [p for p in range(self.manifest.panels) if not self.has_panel(emb_id, p)]
        if missing or not self.has_aux(emb_id):
            raise ValueError(
                f"embedding {emb_id!r} incomplete: {len(missing)} panels missing, "
                f"aux={'ok' if self.has_aux(emb_id) else 'missing'}"
            )
        self._refresh_manifest()
        if emb_id not in self.manifest.embeddings:
            self.manifest.embeddings.append(emb_id)
            self._write_manifest()

    def remove_embedding(self, emb_id: str) -> None:
        """Drop an artifact (manifest entry first, then panels: a crash in
        between leaves orphan panels, never a committed id without panels)."""
        _check_id(emb_id)
        self._refresh_manifest()
        if emb_id in self.manifest.embeddings:
            self.manifest.embeddings.remove(emb_id)
            self._write_manifest()
        if self.root is None:
            for key in [k for k in self._ram_panels if k[0] == emb_id]:
                del self._ram_panels[key]
            self._ram_aux.pop(emb_id, None)
        elif (self.root / emb_id).exists():
            with self._maps_lock:
                if (pm := self._maps.pop(emb_id, None)) is not None:
                    self._close_maps(pm)
            shutil.rmtree(self.root / emb_id)

    # -- read path -----------------------------------------------------------

    def embedding(self, emb_id: str) -> "EmbeddingHandle":
        if emb_id not in self.manifest.embeddings:
            raise KeyError(f"embedding {emb_id!r} not committed; have {self.manifest.embeddings}")
        return EmbeddingHandle(self, emb_id)

    def latest(self) -> "EmbeddingHandle":
        """The most recently committed artifact (what "now" queries serve)."""
        if not self.manifest.embeddings:
            raise KeyError("embedding store is empty: nothing committed yet")
        return EmbeddingHandle(self, self.manifest.embeddings[-1])

    def iter_embeddings(self) -> Iterator["EmbeddingHandle"]:
        for eid in self.manifest.embeddings:
            yield EmbeddingHandle(self, eid)


@dataclass(frozen=True)
class EmbeddingHandle:
    """Store-backed stand-in for a resident (n, k) embedding ``Z``.

    ``vol`` / ``deg`` / ``zbar`` expose the sidecar, read once and cached.
    """

    store: EmbeddingStore
    emb_id: str

    # Each panel is its own small file (or RAM entry), a copy out of a kept
    # map: PanelPipeline reads a window of them on its consumer thread, with
    # no prefetch thread (the thread's hand-offs cost more than the reads).
    inline_reads = True

    @property
    def shape(self) -> tuple[int, int]:
        return (self.store.n, self.store.k)

    @property
    def dtype(self) -> np.dtype:
        return self.store.dtype

    @property
    def nbytes(self) -> int:
        return self.store.n * self.store.k * self.store.dtype.itemsize

    @property
    def panel_rows(self) -> int:
        return self.store.panel_rows

    def _aux(self) -> dict[str, np.ndarray]:
        cached = getattr(self, "_aux_cache", None)
        if cached is None:
            cached = self.store.read_aux(self.emb_id)
            object.__setattr__(self, "_aux_cache", cached)
        return cached

    @property
    def vol(self) -> float:
        return float(self._aux()["vol"])

    @property
    def deg(self) -> np.ndarray:
        return self._aux()["deg"]

    @property
    def zbar(self) -> np.ndarray:
        return self._aux()["zbar"]

    def inv_deg(self) -> np.ndarray:
        """1/deg with zero-degree nodes mapped to 0 (isolated nodes have no
        commute-time limit to correct against)."""
        deg = self.deg
        return np.where(deg > 0, 1.0 / np.maximum(deg, 1e-30), 0.0).astype(np.float32)

    def _panel_maps(self) -> _PanelMaps | None:
        """The store's kept maps of this artifact, checked at the handle's
        first panel read (None for a RAM-backed store)."""
        maps = getattr(self, "_maps", None)
        if maps is None and self.store.root is not None:
            maps = self.store._open_maps(self.emb_id)
            object.__setattr__(self, "_maps", maps)
        return maps

    def _panel_range(self, row0: int, height: int) -> range:
        pr = self.store.panel_rows
        if row0 % pr or height % pr:
            raise ValueError(f"panel [{row0}:{row0 + height}] not panel-aligned (panel={pr})")
        return range(row0 // pr, (row0 + height) // pr)

    def _read(self, row0: int, height: int, *, decode: bool) -> tuple[np.ndarray, int]:
        """Rows [row0, row0 + height) stacked from their store panels, and
        the stored bytes read."""
        rows, stored = [], 0
        maps = self._panel_maps()
        for p in self._panel_range(row0, height):
            arr, nbytes = self.store.read_panel_stored_info(self.emb_id, p, maps)
            rows.append(self.store.decode(arr) if decode else arr)
            stored += nbytes
        return (rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)), stored

    def read_panel(self, row0: int, height: int) -> np.ndarray:
        return self._read(row0, height, decode=True)[0]

    def read_panel_info(self, row0: int, height: int) -> tuple[np.ndarray, int]:
        return self._read(row0, height, decode=True)

    def read_panel_encoded_info(self, row0: int, height: int) -> tuple[np.ndarray, int, int]:
        """Stored-form panel for the kernel's decode (bf16: uint16 bit
        patterns, half the decoded H2D bytes; raw: already decoded)."""
        panel, stored = self._read(row0, height, decode=self.store.codec.name != "bf16")
        return panel, stored, panel.size * self.store.dtype.itemsize

    def read_rows(self, rows) -> np.ndarray:
        """Gather a few Z rows (query vectors) through host panel reads."""
        rows = np.asarray(rows).reshape(-1)
        pr = self.store.panel_rows
        out = np.empty((rows.size, self.store.k), self.store.dtype)
        maps = self._panel_maps()
        for p in np.unique(rows // pr):
            panel = self.store.decode(self.store.read_panel_stored_info(self.emb_id, int(p), maps)[0])
            sel = rows // pr == p
            out[sel] = panel[rows[sel] - int(p) * pr]
        return out

    def to_numpy(self) -> np.ndarray:
        """Gather the whole sketch (tests / small n only)."""
        return np.asarray(self.read_panel(0, self.store.n))
