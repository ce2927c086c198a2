"""A null metrics registry with the call surface of
mythril_tpu/observe/metrics.py.

Every function keeps the reference's signature and records nothing:
counters and gauges read 0, histograms are never observed, a snapshot is
empty. The plugins copied from the JAX package (benchmark,
instruction_profiler) keep their calls. The port's own registry replaces
this module (ROADMAP A 14)."""

from __future__ import annotations

import json
import os
from typing import List


def inc(name: str, value=1) -> None:
    """Add `value` to a counter: recorded nowhere."""


def set_gauge(name: str, value) -> None:
    """Set a gauge: recorded nowhere."""


def observe(name: str, value, label: str = "") -> None:
    """One observation on a histogram: recorded nowhere."""


def value(name: str):
    """A counter's or gauge's value: always 0."""
    return 0


def histogram(name: str, label: str = ""):
    """The histogram of (name, label): never observed, so None."""
    return None


def labels(name: str) -> List[str]:
    """The labels observed on a histogram: none."""
    return []


def snapshot() -> dict:
    """Every metric's state: an empty registry."""
    return {}


def reset(prefix: str = "") -> None:
    """Zero the metrics under `prefix`: there are none."""


def write_snapshot(path: str) -> str:
    """Write :func:`snapshot` (empty) as JSON, atomically; returns `path`."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as handle:
        handle.write(json.dumps(snapshot()) + "\n")
    os.replace(tmp, path)
    return path
