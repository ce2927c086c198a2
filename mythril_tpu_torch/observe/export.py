"""Prometheus exposition + snapshot ring over the metric registry.

The read-side counterpart to the write-side registry in
``observe/metrics.py``: this module renders every *declared* metric as
Prometheus text exposition (format 0.0.4) and keeps a bounded
in-process time-series ring of full snapshots, so a fleet scheduler can
scrape a running daemon (``GET /metrics`` on the HTTP shim, the
``metrics`` protocol op over stdio/socket) instead of waiting for a
post-mortem trace file.

Rendering rules:

* dotted metric names become ``mythril_tpu_<name with . -> _>``;
* every series carries a ``# HELP`` line with the registry doc and a
  ``# TYPE`` line from the declared kind (counter / gauge / histogram
  — histograms render as Prometheus *summaries*: ``quantile`` labels
  from the bounded reservoir plus exact ``_sum`` / ``_count``);
* per-label histogram breakdowns (e.g. per-opcode latency) become a
  ``label="..."`` dimension on the same series;
* counters and gauges that were never emitted still render (value 0),
  so a scrape always names the full declared surface.

Device-memory accounting lives here too: :func:`collect_device_memory`
reads ``torch.cuda.memory_stats`` *host-side at scrape/snapshot time*
and publishes the HBM live/peak gauges — deliberately never sampled
inside the frontier loop, so the exporter adds no device sync to it.

Stdlib-only at import time (torch is imported inside
:func:`collect_device_memory`).

The port's copy of mythril_tpu/observe/export.py; the snapshot ring's
capacity is a keyword default where the JAX package reads
MYTHRIL_TPU_METRICS_RING.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import metrics

#: snapshots the ring keeps unless it is given another capacity
RING_CAPACITY = 256

#: exposition content type, for HTTP transports
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

PREFIX = "mythril_tpu"


def prometheus_name(name: str) -> str:
    """``dispatch.flush.latency_ms`` -> ``mythril_tpu_dispatch_flush_latency_ms``."""
    return PREFIX + "_" + name.replace(".", "_").replace("-", "_")


def _escape_help(doc: str) -> str:
    return doc.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return repr(value)
    return "0"


def _series(name: str, value, **labels) -> str:
    if labels:
        pairs = ",".join(f'{key}="{_escape_label(str(val))}"'
                         for key, val in labels.items())
        return f"{name}{{{pairs}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def _render_hist(lines: List[str], prom: str, label: str,
                 hist: "metrics._Hist") -> None:
    extra = {"label": label} if label else {}
    for q, _key in metrics.QUANTILES:
        lines.append(_series(prom, hist.quantile(q),
                             **extra, quantile=_fmt(float(q))))
    lines.append(_series(prom + "_sum", hist.total, **extra))
    lines.append(_series(prom + "_count", hist.count, **extra))
    if hist.dropped:
        lines.append(_series(prom + "_reservoir_dropped", hist.dropped,
                             **extra))


def render_prometheus() -> str:
    """The full registry as Prometheus text exposition (0.0.4)."""
    lines: List[str] = []
    with metrics._STORE.lock:
        scalars = dict(metrics._STORE.scalars)
        hists = {name: dict(by_label)
                 for name, by_label in metrics._STORE.hists.items()}
    for spec in metrics._METRICS:
        prom = prometheus_name(spec.name)
        lines.append(f"# HELP {prom} {_escape_help(spec.doc)}")
        if spec.kind == metrics.HISTOGRAM:
            # reservoir quantiles + exact sum/count = a summary series
            lines.append(f"# TYPE {prom} summary")
            by_label = hists.get(spec.name)
            if not by_label:
                lines.append(_series(prom + "_sum", 0.0))
                lines.append(_series(prom + "_count", 0))
                continue
            for label, hist in sorted(by_label.items()):
                _render_hist(lines, prom, label, hist)
        elif spec.kind == metrics.COUNTER:
            lines.append(f"# TYPE {prom} counter")
            lines.append(_series(prom + "_total",
                                 scalars.get(spec.name, 0)))
        else:
            lines.append(f"# TYPE {prom} gauge")
            lines.append(_series(prom, scalars.get(spec.name, 0)))
    return "\n".join(lines) + "\n"


def collect_device_memory() -> Dict[str, int]:
    """Sample ``torch.cuda.memory_stats`` (the caching allocator's
    ``allocated_bytes.all.current`` and ``.peak``) across the visible
    CUDA devices and publish the HBM gauges. Host-side, scrape-time only
    — never called from the frontier loop, so no device syncs ride the
    hot path. Returns ``{}`` without CUDA (or without stats)."""
    try:
        import torch
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    except Exception:  # noqa: BLE001 — exporter must work without CUDA
        return {}
    in_use = 0
    peak = 0
    sampled = 0
    for index in range(count):
        try:
            stats = torch.cuda.memory_stats(index)
        except Exception:  # noqa: BLE001 — a device without stats
            continue
        if not stats:
            continue
        sampled += 1
        in_use += int(stats.get("allocated_bytes.all.current", 0))
        peak += int(stats.get("allocated_bytes.all.peak",
                              stats.get("allocated_bytes.all.current", 0)))
    if not sampled:
        return {}
    metrics.set_gauge("device.hbm.bytes_in_use", in_use)
    metrics.set_gauge("device.hbm.peak_bytes", peak)
    return {"bytes_in_use": in_use, "peak_bytes": peak,
            "devices": sampled}


class SnapshotRing:
    """Bounded in-process time series: the last N full metric
    snapshots, stamped with wall time and a monotonic sequence number.
    The `metrics` protocol op serves its tail so a scraper that missed
    a window can still see the recent trajectory."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=self.capacity)
        self._seq = 0

    def record(self, **context) -> dict:
        """Append one snapshot entry (plus caller context, e.g. the
        request id that just finished). Returns the entry."""
        entry = {"ts": round(time.time(), 6), "metrics": metrics.snapshot()}
        entry.update(context)
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._entries.append(entry)
        return entry

    def tail(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            entries = list(self._entries)
        if last is not None:
            entries = entries[-max(0, int(last)):]
        return entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_RING: Optional[SnapshotRing] = None
_RING_LOCK = threading.Lock()


def ring(capacity: int = RING_CAPACITY) -> SnapshotRing:
    """The process-wide snapshot ring; `capacity` counts at its first use
    (ring size is a run setting, like the trace buffer)."""
    global _RING
    with _RING_LOCK:
        if _RING is None:
            _RING = SnapshotRing(capacity)
        return _RING


def record_snapshot(**context) -> dict:
    """Record one entry on the process ring."""
    return ring().record(**context)


def reset_ring() -> None:
    """Test hook: drop the ring so the next use sizes a new one."""
    global _RING
    with _RING_LOCK:
        _RING = None
