"""The port's observability: unified tracing, metrics, structured logs and
their export (the port's copy of mythril_tpu/observe/).

* :mod:`.trace` — a low-overhead span tracer (``trace.span(...)``
  context manager, ``trace.traced`` decorator, ``trace.instant`` point
  events, ``trace.counter`` counter tracks) over a thread-safe ring
  buffer, exporting Chrome/Perfetto ``trace_event`` JSON. Enabled by
  ``analyze --trace-out`` or ``trace.enable(path)``; when disabled,
  ``span()`` returns one shared no-op object.
* :mod:`.metrics` — the typed registry (counters, gauges, histograms,
  each declared with name, kind, unit and doc), always live; the
  reference's names, kinds and units, in its order. ``analyze
  --metrics-out`` writes its snapshot. ``SolverStatistics`` fields are
  facade properties over it.
* :mod:`.export` — Prometheus text exposition of the registry, a
  bounded snapshot ring and the scrape-time CUDA memory gauges.
* :mod:`.slog` — structured JSON-lines logging with a ``ContextVar``
  correlation id, enabled by ``slog.enable(sink)``.

The port reads no environment knob: paths, sinks and sizes are
arguments. ``python -m tools.traceview`` and ``python -m
tools.frontierview`` read the files either package writes.
"""

from . import export, metrics, slog, trace  # noqa: F401

__all__ = ["export", "metrics", "slog", "trace"]
