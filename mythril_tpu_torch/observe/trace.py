"""Low-overhead span tracer with Chrome/Perfetto ``trace_event`` export.

Usage at an instrumentation site::

    from ...observe import trace

    with trace.span("dispatch.flush", occupancy=len(entries)) as sp:
        ...
        sp.set(decided=n_decided)          # attrs may land at exit too

    @trace.traced("frontier.host_drain")   # decorator form
    def _flush_backlog(self, backlog): ...

    trace.instant("resilience.breaker_trip", backend="device")

Design constraints, in order:

* **No-op when disabled.** ``span()`` returns one shared null context
  manager — no timestamp read, no event, no buffer touch. The decorator
  checks the enabled flag per call, so a tracer enabled after import
  still sees decorated functions. Tracing must cost < 2% when off,
  which is why events are flat tuples and the hot check is one attribute
  load.
* **Thread-safe ring buffer.** Events append to a ``deque(maxlen=N)``
  (atomic under the GIL); N is ``enable``'s ``buffer_events``.
  When the buffer wraps, the oldest events drop and the export records
  how many (``otherData.dropped_events``) — a trace that silently lost
  its head would misreport every rollup.
* **Perfetto-loadable output.** ``export()`` writes the Chrome
  ``trace_event`` JSON object format: ``X`` complete events (ts/dur in
  microseconds), ``i`` instants, ``C`` counter-track samples (args =
  series values; the frontier telemetry decode emits these per chunk),
  ``M`` process/thread metadata, and the run manifest under
  ``otherData``. Load it at https://ui.perfetto.dev or feed it to
  ``python -m tools.traceview`` / ``python -m tools.frontierview``.

Enablement: ``analyze --trace-out out.json`` or ``enable(path,
buffer_events=...)`` programmatically; the port reads no environment
knob (the JAX package's MYTHRIL_TPU_TRACE and MYTHRIL_TPU_TRACE_BUFFER
are these arguments). Span categories derive from the name's leading
dotted component ("dispatch.flush" -> cat "dispatch") — traceview's
per-phase rollup groups on them.

The port's copy of mythril_tpu/observe/trace.py.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

#: ring capacity unless ``enable`` is given another (at least 1024)
DEFAULT_BUFFER_EVENTS = 1 << 16


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path. One instance
    serves every call site (tests pin ``span() is span()``)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records an ``X`` complete event at exit."""

    __slots__ = ("_tracer", "name", "attrs", "_start")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        self._tracer._record(
            "X", self.name, self._start, end - self._start, self.attrs)
        return False

    def set(self, **attrs) -> "_Span":
        """Attach attrs discovered mid-span (exported with the event)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self


class Tracer:
    """Process-wide tracer singleton (module-level ``_TRACER``)."""

    def __init__(self):
        self.enabled = False
        self.out_path: Optional[str] = None
        self._atexit_armed = False
        self._lock = threading.Lock()
        self._events: Optional[deque] = None
        self._total_events = 0
        self._t0 = 0.0
        self._manifest: Dict[str, object] = {}

    # -- lifecycle -------------------------------------------------------------------

    def enable(self, out_path: str,
               buffer_events: int = DEFAULT_BUFFER_EVENTS) -> None:
        with self._lock:
            if self.enabled and self.out_path == out_path:
                # idempotent re-enable: a serve daemon enables the tracer
                # at startup (warmup span) and each embedded analyzer
                # re-enables the same path per request — resetting the
                # buffer here would drop every span before the newest
                # request
                return
            self.out_path = out_path
            self._events = deque(maxlen=max(1024, int(buffer_events)))
            self._total_events = 0
            self._t0 = time.perf_counter()
            self._manifest.setdefault("started_at",
                                      time.strftime("%Y-%m-%dT%H:%M:%S"))
            self.enabled = True
            if not self._atexit_armed:
                self._atexit_armed = True
                atexit.register(self._export_at_exit)

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Test hook: back to the never-touched state (buffer and manifest
        dropped)."""
        with self._lock:
            self.enabled = False
            self.out_path = None
            self._events = None
            self._total_events = 0
            self._manifest = {}

    # -- recording -------------------------------------------------------------------

    def _record(self, ph: str, name: str, start: float,
                dur: Optional[float], attrs: Optional[dict]) -> None:
        if not self.enabled:
            return  # raced a disable(); drop silently
        self._total_events += 1
        self._events.append(
            (ph, name, start - self._t0, dur, threading.get_ident(), attrs))

    def instant(self, name: str, attrs: Optional[dict]) -> None:
        self._record("i", name, time.perf_counter(), None, attrs)

    def counter(self, name: str, values: dict) -> None:
        """Perfetto counter ('C') sample: each key of `values` is one
        series on the track named `name` — Perfetto renders them as
        stacked area curves over the run timeline (frontier occupancy,
        escape rates, arena fill)."""
        self._record("C", name, time.perf_counter(), None, values)

    def set_manifest(self, **entries) -> None:
        with self._lock:
            self._manifest.update(entries)

    # -- export ----------------------------------------------------------------------

    def _export_at_exit(self) -> None:
        try:
            if self.enabled and self.out_path and self._total_events:
                self.export()
        except Exception:  # noqa: BLE001 — never let atexit raise
            pass

    def export(self, out_path: Optional[str] = None) -> str:
        """Write the Perfetto JSON; returns the path written. Idempotent:
        call mid-run for a partial trace, the atexit hook rewrites the
        final one."""
        path = out_path or self.out_path
        if path is None:
            raise ValueError("tracer has no output path; enable() first")
        with self._lock:
            events = list(self._events or ())
            dropped = self._total_events - len(events)
            manifest = dict(self._manifest)
        pid = os.getpid()
        tids = sorted({event[4] for event in events})
        tid_map = {ident: index for index, ident in enumerate(tids)}
        trace_events = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "mythril-tpu"},
        }]
        for ident, tid in tid_map.items():
            trace_events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": "main" if tid == 0 else f"thread-{tid}"},
            })
        for ph, name, start, dur, ident, attrs in events:
            event = {
                "ph": ph, "name": name, "cat": name.split(".", 1)[0],
                "ts": round(start * 1e6, 3), "pid": pid,
                "tid": tid_map[ident],
            }
            if ph == "X":
                event["dur"] = round((dur or 0.0) * 1e6, 3)
            elif ph == "i":
                event["s"] = "t"  # thread-scoped instant
            if attrs:
                event["args"] = {key: _jsonable(value)
                                 for key, value in attrs.items()}
            trace_events.append(event)
        manifest["dropped_events"] = dropped
        manifest["total_events"] = self._total_events
        payload = {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {key: _jsonable(value)
                          for key, value in sorted(manifest.items())},
        }
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as handle:
            json.dump(payload, handle)
        os.replace(tmp, path)
        return path


def _jsonable(value):
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


_TRACER = Tracer()


def span(name: str, **attrs):
    """Context manager timing one phase. Attrs become Perfetto ``args``;
    add exit-time ones via ``.set(...)``. Returns the shared null span
    when tracing is off."""
    tracer = _TRACER
    if not tracer.enabled:
        return _NULL_SPAN
    return _Span(tracer, name, attrs or None)


def traced(name: str, **attrs):
    """Decorator form of :func:`span`. The enabled check happens per
    call, so tracers enabled after import still see the function."""
    def decorate(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with span(name, **attrs):
                return func(*args, **kwargs)
        return wrapper
    return decorate


def instant(name: str, **attrs) -> None:
    """Point-in-time event (breaker trips, quarantines, hand-overs)."""
    tracer = _TRACER
    if tracer.enabled:
        tracer.instant(name, attrs or None)


def counter(name: str, **values) -> None:
    """Sample the named counter track: every kwarg is one series value
    (Chrome trace_event 'C' phase). No-op when tracing is off."""
    tracer = _TRACER
    if tracer.enabled:
        tracer.counter(name, values)


def enabled() -> bool:
    return _TRACER.enabled


def enable(out_path: str, buffer_events: int = DEFAULT_BUFFER_EVENTS) -> None:
    """Start recording into a ring of `buffer_events` events (at least
    1024); `export` writes them to `out_path`."""
    _TRACER.enable(out_path, buffer_events)


def disable() -> None:
    _TRACER.disable()


def reset() -> None:
    _TRACER.reset()


def set_manifest(**entries) -> None:
    """Merge run-manifest entries (argv, backend, contract, knobs) into
    the export's ``otherData``."""
    _TRACER.set_manifest(**entries)


def export(out_path: Optional[str] = None) -> Optional[str]:
    """Write the trace now (no-op returning None when disabled)."""
    if not _TRACER.enabled:
        return None
    return _TRACER.export(out_path)


def out_path() -> Optional[str]:
    return _TRACER.out_path
