"""Span tracer recording Chrome trace-event spans.

Port of :mod:`repro.obs.trace`: same-thread spans, and cross-thread spans
(:func:`begin` on one thread, :func:`end` on another -- the panel pipeline's
``prefetch.panel`` spans).  :meth:`Tracer.save` writes them as Chrome
trace-event JSON ("X" complete events plus "M" thread-name metadata),
loadable in Perfetto or chrome://tracing.  Tracing is off by default and
the disabled path returns a shared null span.  CUDA work is
queued asynchronously, so a span that only brackets the enqueue
under-reports the device wall: with ``enable_tracing(fence=True)`` a span on
which ``sp.fence(x)`` was called runs ``torch.cuda.synchronize()`` before it
closes, and its duration is the device phase's wall.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

from repro_torch.device import synchronize


def _now_us() -> float:
    return time.perf_counter_ns() / 1000.0


class _NullSpan:
    """Shared no-op span: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def annotate(self, **args: Any) -> None:
        return None

    def fence(self, value: Any) -> None:
        return None


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span; records one "X" event on exit."""

    __slots__ = ("_tracer", "name", "args", "t0", "tid", "_fence")

    def __init__(self, tracer_: "Tracer", name: str, args: dict[str, Any]):
        self._tracer = tracer_
        self.name = name
        self.args = args
        self.tid = threading.get_ident()
        self.t0 = 0.0
        self._fence = None

    def __enter__(self) -> "_Span":
        self.t0 = _now_us()
        return self

    def annotate(self, **args: Any) -> None:
        self.args.update(args)

    def fence(self, value: Any) -> None:
        """Register a device value to wait for at span exit (if fencing is on)."""
        self._fence = value

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._fence is not None and self._tracer.fence_enabled:
            synchronize(self._fence)
        self._tracer._record(self.name, self.t0, _now_us() - self.t0, self.tid, self.args)
        return None


class Tracer:
    """Span recorder; one process-global instance behind :func:`tracer`."""

    def __init__(self) -> None:
        self.enabled = False
        self.fence_enabled = False
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._thread_names: dict[int, str] = {}
        # Cross-thread spans in flight: handle -> (name, t0_us, owner tid, args)
        self._pending: dict[int, tuple[str, float, int, dict[str, Any]]] = {}
        self._next_handle = 1

    def enable(self, fence: bool = False) -> "Tracer":
        self.enabled = True
        self.fence_enabled = fence
        return self

    def disable(self) -> None:
        self.enabled = False
        self.fence_enabled = False

    def clear(self) -> None:
        """Drop every recorded and pending span."""
        with self._lock:
            self._events.clear()
            self._thread_names.clear()
            self._pending.clear()

    def span(self, name: str, **args: Any):
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def begin(self, name: str, **args: Any) -> int:
        """Open a cross-thread span; returns a handle (0 when disabled).

        The calling thread owns the span: the event lands on its track even
        if another thread ends it.
        """
        if not self.enabled:
            return 0
        tid = threading.get_ident()
        t0 = _now_us()
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            self._pending[handle] = (name, t0, tid, args)
            self._note_thread_locked(tid)
        return handle

    def end(self, handle: int, **args: Any) -> None:
        """Close a span opened by :meth:`begin` from any thread; no-op for 0."""
        if handle == 0:
            return
        t1 = _now_us()
        end_tid = threading.get_ident()
        with self._lock:
            pending = self._pending.pop(handle, None)
        if pending is None:
            return
        name, t0, tid, ev_args = pending
        ev_args = {**ev_args, **args}
        if end_tid != tid:
            ev_args["end_tid"] = end_tid
        self._record(name, t0, t1 - t0, tid, ev_args)

    def _record(self, name: str, t0: float, dur: float, tid: int, args: dict) -> None:
        with self._lock:
            self._note_thread_locked(tid)
            self._events.append({
                "name": name, "ph": "X", "ts": t0, "dur": max(dur, 0.0),
                "pid": os.getpid(), "tid": tid, "args": args,
            })

    def _note_thread_locked(self, tid: int) -> None:
        # Called on the span's owning thread (a cross-thread span's owner is
        # named at begin), so the current thread's name is the track's.
        if tid not in self._thread_names and tid == threading.get_ident():
            self._thread_names[tid] = threading.current_thread().name

    def events(self) -> list[dict[str, Any]]:
        """Recorded spans as Chrome trace-event ("X") dicts."""
        with self._lock:
            return [dict(e) for e in self._events]

    def to_chrome_trace(self) -> dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto / chrome://tracing)."""
        with self._lock:
            pid = os.getpid()
            meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                     "args": {"name": tname}}
                    for tid, tname in sorted(self._thread_names.items())]
            return {
                "traceEvents": meta + [dict(e) for e in self._events],
                "displayTimeUnit": "ms",
                "otherData": {"clock": "perf_counter", "unit": "us"},
            }

    def save(self, path: str) -> None:
        """Write :meth:`to_chrome_trace` to ``path`` (atomically, via a temporary)."""
        doc = self.to_chrome_trace()
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)


_TRACER = Tracer()


def tracer() -> Tracer:
    return _TRACER


def enable_tracing(fence: bool = False) -> Tracer:
    return _TRACER.enable(fence=fence)


def disable_tracing() -> None:
    _TRACER.disable()


def tracing_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **args: Any):
    """Open a span on the global tracer (null span when disabled)."""
    return _TRACER.span(name, **args)


def begin(name: str, **args: Any) -> int:
    """Open a cross-thread span on the global tracer (handle 0 when disabled)."""
    return _TRACER.begin(name, **args)


def end(handle: int, **args: Any) -> None:
    """Close a cross-thread span from any thread."""
    _TRACER.end(handle, **args)
