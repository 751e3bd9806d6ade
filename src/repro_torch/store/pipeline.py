"""Panel I/O pipeline: all host-to-device staging of streamed row panels.

Port of :mod:`repro.store.pipeline`.  :class:`PanelPipeline` walks row-panel
origins of one or more operands:

* a **background prefetch thread** fetches (and codec-decodes) each
  streamed operand's panel on the host -- file reads and decode only, never
  CUDA work.  Operands whose panels are small reads say so with
  ``inline_reads = True`` (an embedding artifact: one small file per panel,
  microseconds to read, where a second Python thread costs the consumer
  more in contention for the interpreter than it hides).  No prefetch
  thread runs for them: the consumer reads the next ``FETCH_WINDOW`` origins
  in one go when its window runs out, then stages them;
* **per-operand ring buffers** of depth ``depth`` (default 2) bound host
  staging and give backpressure;
* the consumer thread **stages panel t+1 before panel t is yielded**.  On
  the card every panel goes through a pinned host buffer and a
  ``non_blocking`` copy.  A panel of ``SIDE_STREAM_MIN_BYTES`` or more is
  copied on a side CUDA stream: the compute stream waits on the copy's
  event when the panel is yielded, and the staged tensor is
  ``record_stream``-ed so the caching allocator cannot hand its memory out
  while the compute stream still reads it.  A smaller panel (an embedding
  panel of the query path) is copied on the compute stream itself: its copy
  takes microseconds, less than the event, the wait and ``record_stream``
  cost the host.  Pinning is the path: a failure to pin raises (there is
  no pageable fallback).  With ``device="cpu"``
  nothing is copied to a card: panels become tensors through
  ``torch.from_numpy(np.array(...))`` (memory-mapped tiles are read-only);
* **grid placement** (``grid=``, a
  :class:`~repro_torch.core.distmatrix.DistContext`, the counterpart of the
  JAX pipeline's ``sharding=``; ``device=`` means its 1x1 grid): on a grid
  larger than 1x1 a panel of ``ph`` rows is yielded as a DistMatrix of
  R x C tiles of ``(ph / R, n / C)``, each contiguous on its own grid
  device.  The host panel is copied once into one pinned buffer laid out
  tile after tile (:func:`to_device_tiles`), and each tile goes from its
  slice of that buffer straight to its own card, that card current, on
  that card's side stream (by the tile's bytes, as above); nothing is
  staged through the home device.  (A column slice of a pinned row panel is not contiguous, and
  ``Tensor.to`` copies such a source through a pageable temporary first,
  which waits for the copy: the tile-major layout avoids that.)  Resident
  operands are cut into the same panel tiles (``DistContext.row_panel``);
* **encoded shipping** (``encoded=True``): bf16 tiles travel as their uint16
  bit patterns, carried in torch as ``int16`` views (torch has no complete
  ``uint16`` type; every consumer reinterprets the bits), half the decoded
  bytes; the gap is counted in ``stats.bytes_h2d_saved``;
* **accounting**: ``panels``, ``bytes_h2d``, ``bytes_read``,
  ``bytes_decoded`` and the ``stream.peak_live_bytes`` gauge on ``stats``
  exactly as the JAX pipeline counts them, plus the
  ``pipeline.producer_fetch_seconds`` (every panel read, on whichever
  thread) / ``pipeline.consumer_wait_seconds`` (the consumer blocked on
  the prefetch thread) registry counters, ``pipeline.pin_copy_seconds`` (the consumer's host
  copies into pinned buffers) and, with tracing on, one cross-thread
  ``prefetch.panel`` span per fetched panel.

Operands that are not snapshot handles (resident tensors) are sliced on the
consumer thread and are not counted.

:class:`CachingHandle` wraps a handle with a host-RAM panel cache, so a
consumer that re-streams the same matrix (the solver re-reading P2 every
iteration) hits the backing store once per batch; replays are bitwise equal
and report zero ``bytes_read``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import REGISTRY as _OBS_REGISTRY

DEFAULT_PREFETCH_DEPTH = 2
SIDE_STREAM_MIN_BYTES = 1 << 20  # smaller panels are copied on the compute stream
FETCH_WINDOW = 64  # origins read in one go for inline_reads operands (their host staging)


def _is_handle(x) -> bool:
    """Streamable snapshot handle (duck-typed, mirrors tiles.is_streamable)."""
    return hasattr(x, "read_panel") and hasattr(x, "panel_rows")


def fetch_panel_info(source, row0: int, height: int) -> tuple[np.ndarray, int]:
    """``(host_panel, stored_nbytes)`` for a snapshot handle; a handle with
    only ``read_panel`` counts its decoded bytes as stored."""
    if hasattr(source, "read_panel_info"):
        panel, stored = source.read_panel_info(row0, height)
        return np.asarray(panel), int(stored)
    panel = np.asarray(source.read_panel(row0, height))
    return panel, panel.nbytes


def fetch_panel_encoded_info(source, row0: int, height: int) -> tuple[np.ndarray, int, int]:
    """``(panel, stored_nbytes, decoded_nbytes)``, the panel in its
    device-decodable stored form where the source has one (bf16: uint16
    bits); otherwise the decoded panel with ``decoded_nbytes == panel.nbytes``.
    """
    if hasattr(source, "read_panel_encoded_info"):
        panel, stored, decoded = source.read_panel_encoded_info(row0, height)
        return np.asarray(panel), int(stored), int(decoded)
    panel, stored = fetch_panel_info(source, row0, height)
    return panel, stored, panel.nbytes


def host_tensor(panel: np.ndarray) -> torch.Tensor:
    """A writable CPU tensor copy of a host panel; uint16 bits become int16."""
    arr = np.array(panel)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return torch.from_numpy(arr)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.int16 if dtype == np.uint16 else torch.from_numpy(np.zeros(0, dtype)).dtype


def to_device_tiles(panel: np.ndarray, grid, streams: dict | None = None):
    """Copy a host panel onto ``grid`` as its R x C tiles (on a 1x1 grid the
    whole panel); returns ``(tiles, events)``, R x C lists.

    CUDA tiles come from one pinned buffer per panel (pinning is the path: a
    failure to pin raises), filled by one host copy in tile-major order
    (``(R, C, ph / R, n / C)``), so every tile is a contiguous pinned slice
    and its ``non_blocking`` copy is asynchronous.  Each copy runs with its
    tile's card current, on ``streams[card]`` when ``streams`` has one (then
    an event marks its end, and a consumer must wait on it before reading
    the tile) or on the card's current stream.  CPU tiles are contiguous
    host copies.
    """
    panel = np.asarray(panel)
    R, C = grid.n_row_shards, grid.n_col_shards
    h, w = panel.shape
    pr, pc = h // R, w // C
    if R * pr != h or C * pc != w:
        raise ValueError(f"panel {panel.shape} does not divide the {R}x{C} grid")
    devs = [[grid.device(r, c) for c in range(C)] for r in range(R)]
    pinned = None
    if any(d.type == "cuda" for row in devs for d in row):
        t0 = time.perf_counter()
        pinned = torch.empty((R, C, pr, pc), dtype=_torch_dtype(panel.dtype), pin_memory=True)
        src = panel.view(np.int16) if panel.dtype == np.uint16 else panel
        np.copyto(pinned.numpy(), src.reshape(R, pr, C, pc).transpose(0, 2, 1, 3))
        _OBS_REGISTRY.inc("pipeline.pin_copy_seconds", time.perf_counter() - t0)
    tiles = [[None] * C for _ in range(R)]
    events = [[None] * C for _ in range(R)]
    for r in range(R):
        for c in range(C):
            dev = devs[r][c]
            if dev.type != "cuda":
                tiles[r][c] = host_tensor(panel[r * pr:(r + 1) * pr, c * pc:(c + 1) * pc]).to(dev)
                continue
            stream = None if streams is None else streams.get(dev)
            with torch.cuda.device(dev):
                if stream is None:
                    tiles[r][c] = pinned[r, c].to(dev, non_blocking=True)
                    continue
                with torch.cuda.stream(stream):
                    tiles[r][c] = pinned[r, c].to(dev, non_blocking=True)
                    events[r][c] = torch.cuda.Event()
                    events[r][c].record(stream)
    return tiles, events


class _Ring:
    """Bounded single-producer/single-consumer ring buffer (one per operand)."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self.depth = depth
        self._buf: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    def put(self, item) -> bool:
        """Block until a slot frees; False once the ring is closed."""
        with self._cv:
            while len(self._buf) >= self.depth and not self._closed:
                self._cv.wait()
            if self._closed:
                return False
            self._buf.append(item)
            self._cv.notify_all()
            return True

    def get(self):
        """Next item, blocking; None once closed (drained items still served)."""
        with self._cv:
            while not self._buf and not self._closed:
                self._cv.wait()
            if self._buf:
                item = self._buf.popleft()
                self._cv.notify_all()
                return item
            return None

    def close(self, *, drain: bool = False) -> None:
        """Stop accepting puts; ``drain=True`` keeps buffered items poppable."""
        with self._cv:
            self._closed = True
            if not drain:
                self._buf.clear()
            self._cv.notify_all()


class PanelPipeline:
    """Prefetching iterator over row panels of one or more operands.

    Yields ``(row0, panels)`` per origin, in order, one entry per operand.
    ``device=None`` yields host numpy panels (the out-of-core GEMM slices
    its left panel on the host); with a device, each streamed panel is a
    tensor on it, staged one origin ahead; with a ``grid`` larger than 1x1,
    a DistMatrix of the grid's tiles (a 1x1 grid means its one device).  Use as a context manager (or
    call :meth:`close`) so an early exit cancels the producer.
    """

    def __init__(
        self,
        sources: Sequence,
        origins: Sequence[int],
        height: int,
        *,
        depth: int | None = None,
        device: str | torch.device | None = None,
        grid=None,
        stats=None,
        encoded: bool = False,
    ):
        self.sources = list(sources)
        self.origins = list(origins)
        self.height = int(height)
        self.depth = DEFAULT_PREFETCH_DEPTH if depth is None else int(depth)
        if self.depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {self.depth}")
        if grid is None and device is not None:
            from repro_torch.core.distmatrix import trivial_context  # core imports the store lazily

            grid = trivial_context(device)
        self.grid = grid  # None: host mode
        self.device = None if grid is None else grid.home
        self.stats = stats
        self.encoded = bool(encoded)
        self._copy_streams: dict = {}  # side copy stream per card
        self._threaded = [_is_handle(s) for s in self.sources]
        streamed = [s for s, t in zip(self.sources, self._threaded) if t]
        self._windowed = bool(streamed) and all(
            getattr(s, "inline_reads", False) for s in streamed)
        self._window: deque = deque()  # (row0, per-operand fetched entries or an error)
        self._next_origin = 0  # index of the first origin not yet read into a window
        self._rings = [_Ring(self.depth) if t and not self._windowed else None
                       for t in self._threaded]
        self._cancel = threading.Event()
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self.device_live_bytes = 0  # pipeline-owned panel bytes currently staged
        if any(self._threaded) and self.origins and not self._windowed:
            self._thread = threading.Thread(
                target=self._produce, name="panel-prefetch", daemon=True
            )
            self._thread.start()

    # -- producer (background thread: host I/O + codec decode only) ----------

    def _fetch(self, src, row0: int) -> tuple[np.ndarray, int, int]:
        """One panel read (and decode): ``(panel, stored, decoded)``; counts
        its bytes.  Runs on the prefetch thread, or the consumer's for
        ``inline_reads`` operands."""
        t_f0 = time.perf_counter()
        if self.encoded:
            panel, stored, decoded = fetch_panel_encoded_info(src, row0, self.height)
        else:
            panel, stored = fetch_panel_info(src, row0, self.height)
            decoded = panel.nbytes
        _OBS_REGISTRY.add_named({
            "pipeline.producer_fetch_seconds": time.perf_counter() - t_f0,
            "pipeline.panels_fetched": 1.0,
        })
        if self.stats is not None and stored:
            # stored == 0 is a host-RAM replay (CachingHandle hit): nothing
            # was read from the backing tier or decoded.
            self.stats.add(bytes_read=stored, bytes_decoded=panel.nbytes)
        return panel, stored, decoded

    def _produce(self) -> None:
        try:
            for row0 in self.origins:
                for i, (src, ring) in enumerate(zip(self.sources, self._rings)):
                    if ring is None:
                        continue
                    if self._cancel.is_set():
                        return
                    sp = obs_trace.begin("prefetch.panel", row0=row0, operand=i)
                    panel, _, decoded = self._fetch(src, row0)
                    if not ring.put((panel, decoded, sp)):
                        obs_trace.end(sp, cancelled=True)
                        return
        except BaseException as e:  # hand to the consumer, then stop
            self._error = e
            self._cancel.set()
            for ring in self._rings:
                if ring is not None:
                    ring.close(drain=True)

    # -- consumer ------------------------------------------------------------

    def _read_window(self) -> None:
        """Read the next ``FETCH_WINDOW`` origins of every streamed operand
        into the window, in order; a failed read ends the window at its origin.
        The reads count as ``pipeline.producer_fetch_seconds`` (``_fetch``)
        only: the consumer waits for no other thread here."""
        origins = self.origins[self._next_origin : self._next_origin + FETCH_WINDOW]
        self._next_origin += len(origins)
        for row0 in origins:
            entry = []
            for i, (src, threaded) in enumerate(zip(self.sources, self._threaded)):
                if not threaded:
                    entry.append(None)
                    continue
                sp = obs_trace.begin("prefetch.panel", row0=row0, operand=i)
                try:
                    panel, _, decoded = self._fetch(src, row0)
                except BaseException as e:
                    obs_trace.end(sp, cancelled=True)
                    for fetched in entry:
                        if fetched is not None:
                            obs_trace.end(fetched[2], cancelled=True)
                    self._window.append((row0, e))
                    self._next_origin = len(self.origins)
                    return
                entry.append((panel, decoded, sp))
            self._window.append((row0, entry))

    def _next_host_bundle(self, row0: int) -> tuple[list, list]:
        """Panels (+ decoded byte counts) for one origin: ring pops (or the
        read window's entries) for handles, lazy slices (decoded None) for
        everything else."""
        if self._windowed:
            if not self._window:
                self._read_window()
            if not self._window:
                raise RuntimeError("panel pipeline closed while panels were pending")
            r0, entry = self._window.popleft()
            if isinstance(entry, BaseException):
                self._window.clear()
                raise RuntimeError(f"panel prefetch failed at row {r0}") from entry
            bundle, decs = [], []
            for src, fetched in zip(self.sources, entry):
                if fetched is None:
                    bundle.append(self._slice(src, row0))
                    decs.append(None)
                else:
                    panel, decoded, sp = fetched
                    obs_trace.end(sp)
                    bundle.append(panel)
                    decs.append(decoded)
            return bundle, decs
        bundle, decs = [], []
        for src, ring in zip(self.sources, self._rings):
            if ring is None:
                bundle.append(self._slice(src, row0))
                decs.append(None)
                continue
            t_w0 = time.perf_counter()
            item = ring.get()
            _OBS_REGISTRY.add_named({
                "pipeline.consumer_wait_seconds": time.perf_counter() - t_w0,
                "pipeline.consumer_waits": 1.0,
            })
            if item is None:
                if self._error is not None:
                    raise RuntimeError(f"panel prefetch failed at row {row0}") from self._error
                raise RuntimeError("panel pipeline closed while panels were pending")
            panel, decoded, sp = item
            obs_trace.end(sp)
            bundle.append(panel)
            decs.append(decoded)
        return bundle, decs

    def _slice(self, src, row0: int):
        """A resident operand's rows of one origin (the panel tiles on a grid
        larger than 1x1)."""
        if self.grid is not None and not self.grid.is_trivial:
            return self.grid.row_panel(src, row0, self.height)
        return src[row0 : row0 + self.height]

    def _to_grid(self, panel: np.ndarray):
        """One host panel on the grid: ``(staged, events, bytes)``, the panel
        a tensor and its copy's event on a 1x1 grid, else a DistMatrix of the
        tiles and their R x C events.  A tile of ``SIDE_STREAM_MIN_BYTES`` or
        more is copied on its card's side stream."""
        grid = self.grid
        tile_bytes = panel.nbytes // (grid.n_row_shards * grid.n_col_shards)
        if tile_bytes >= SIDE_STREAM_MIN_BYTES:
            for row in grid.devices:
                for d in row:
                    if d.type == "cuda" and d not in self._copy_streams:
                        self._copy_streams[d] = torch.cuda.Stream(d)
        tiles, events = to_device_tiles(panel, grid, self._copy_streams)
        nbytes = sum(t.numel() * t.element_size() for row in tiles for t in row)
        if grid.is_trivial:
            return tiles[0][0], events[0][0], nbytes
        return grid.assemble(tiles), events, nbytes

    def _stage(self, row0: int) -> tuple[int, list, list, int]:
        """Pop one origin's bundle and copy its streamed panels to the device
        (or the grid's tiles to their devices)."""
        bundle, decs = self._next_host_bundle(row0)
        staged, events, nbytes = [], [], 0
        for panel, decoded, threaded in zip(bundle, decs, self._threaded):
            if not threaded:
                staged.append(panel)
                events.append(None)
                continue
            dev, event, nb = self._to_grid(panel)
            nbytes += nb
            if self.stats is not None:
                inc = {"panels": 1, "bytes_h2d": nb}
                if decoded is not None and decoded > nb:
                    inc["bytes_h2d_saved"] = decoded - nb
                self.stats.add(**inc)
            staged.append(dev)
            events.append(event)
        return row0, staged, events, nbytes

    @staticmethod
    def _wait(t: torch.Tensor, event) -> None:
        if event is not None:
            compute = torch.cuda.current_stream(t.device)
            compute.wait_event(event)
            t.record_stream(compute)

    def _ready(self, staged: list, events: list) -> list:
        """Make each compute stream wait for the copies before the panels (or
        their tiles) are used."""
        for t, event in zip(staged, events):
            if isinstance(event, list):  # a grid panel: one event per tile
                for t_row, e_row in zip(t.tiles, event):
                    for tile, e in zip(t_row, e_row):
                        self._wait(tile, e)
            else:
                self._wait(t, event)
        return staged

    def __iter__(self) -> Iterator[tuple[int, list]]:
        try:
            if not self.origins:
                return
            if self.device is None:
                for row0 in self.origins:
                    yield row0, self._next_host_bundle(row0)[0]
                return
            # Stage origin t+1 before yielding origin t, so its copy overlaps
            # the compute the consumer enqueues on t.
            prev_row0, prev, prev_ev, prev_bytes = self._stage(self.origins[0])
            for row0 in self.origins[1:]:
                _, cur, cur_ev, cur_bytes = self._stage(row0)
                self.device_live_bytes = prev_bytes + cur_bytes
                if self.stats is not None:
                    self.stats._note_live(self.device_live_bytes)
                yield prev_row0, self._ready(prev, prev_ev)
                prev_row0, prev, prev_ev, prev_bytes = row0, cur, cur_ev, cur_bytes
            self.device_live_bytes = prev_bytes
            if self.stats is not None:
                self.stats._note_live(prev_bytes)
            yield prev_row0, self._ready(prev, prev_ev)
            self.device_live_bytes = 0
        finally:
            self.close()

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Cancel the producer and release the rings (idempotent)."""
        self._cancel.set()
        for _, entry in self._window:  # read but never handed on
            for fetched in () if isinstance(entry, BaseException) else entry:
                if fetched is not None:
                    obs_trace.end(fetched[2], cancelled=True)
        self._window.clear()
        for ring in self._rings:
            if ring is not None:
                ring.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "PanelPipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class CachingHandle:
    """Snapshot-handle wrapper with a host-RAM panel cache (solver batching).

    The first pass reads the store and caches the panels; later passes
    replay them bitwise, with zero ``bytes_read``.  :meth:`refresh` drops
    the cache, so the next pass streams from the store again.  Decoded and
    stored-form (encoded) panels are cached apart.
    """

    def __init__(self, handle):
        if not _is_handle(handle):
            raise TypeError(f"{handle!r} does not satisfy the snapshot-handle protocol")
        self.handle = handle
        self._cache: dict[tuple, object] = {}
        self.fills = 0  # store reads (cache misses)
        self.replays = 0  # cache hits

    @property
    def shape(self):
        return self.handle.shape

    @property
    def dtype(self):
        return self.handle.dtype

    @property
    def nbytes(self):
        return self.handle.nbytes

    @property
    def panel_rows(self) -> int:
        return self.handle.panel_rows

    def refresh(self) -> None:
        """Drop cached panels; the next pass streams from the store again."""
        self._cache.clear()

    def read_panel_info(self, row0: int, height: int) -> tuple[np.ndarray, int]:
        key = (row0, height)
        cached = self._cache.get(key)
        if cached is not None:
            self.replays += 1
            return cached, 0
        panel, stored = fetch_panel_info(self.handle, row0, height)
        self._cache[key] = panel
        self.fills += 1
        return panel, stored

    def read_panel_encoded_info(self, row0: int, height: int) -> tuple[np.ndarray, int, int]:
        key = (row0, height, "enc")
        cached = self._cache.get(key)
        if cached is not None:
            self.replays += 1
            panel, decoded = cached
            return panel, 0, decoded
        panel, stored, decoded = fetch_panel_encoded_info(self.handle, row0, height)
        self._cache[key] = (panel, decoded)
        self.fills += 1
        return panel, stored, decoded

    def read_panel(self, row0: int, height: int) -> np.ndarray:
        return self.read_panel_info(row0, height)[0]
