"""Shared helpers for the tests that hold the port's observability
(mythril_tpu_torch/observe/) against the JAX package's.

The two registries and the two tracers are separate module singletons:
`observed(side, run)` resets both of one side, enables its tracer, runs,
and returns what the run left: the registry's snapshot and the exported
trace's events. `deterministic(snapshot)` keeps what two runs on the same
inputs must agree on, `counter_samples(events)` the ordered counter-track
samples and `span_names(events)` the multiset of span and instant names.

What is left out of a comparison, and why, is named once, in
chip_smoke.py (whose observe_tpu phase compares the same way):
TIME_VALUED (wall-clock readings: of a histogram only its observation
counts are kept) and NOT_COMPARED (whole families)."""

import json
import os
from collections import Counter

from chip_smoke import NOT_COMPARED, TIME_VALUED, deterministic  # noqa: F401
from mythril_tpu.observe import metrics as jmetrics
from mythril_tpu.observe import trace as jtrace
from mythril_tpu_torch.observe import metrics as pmetrics
from mythril_tpu_torch.observe import trace as ptrace

OBSERVE = {"jax": (jmetrics, jtrace), "port": (pmetrics, ptrace)}


def load_events(path: str) -> list:
    with open(path, encoding="utf-8") as handle:
        return json.load(handle)["traceEvents"]


def counter_samples(events) -> list:
    """The counter-track ('C') samples in order: (track, its series)."""
    return [(event["name"], event.get("args", {})) for event in events
            if event["ph"] == "C"]


def span_names(events) -> Counter:
    """The multiset of span ('X') and instant ('i') names, xla.* out."""
    return Counter((event["ph"], event["name"]) for event in events
                   if event["ph"] in ("X", "i")
                   and not event["name"].startswith("xla."))


def reset(side: str) -> None:
    metrics, trace = OBSERVE[side]
    metrics.reset()
    trace.reset()


def observed(side: str, run, directory: str) -> dict:
    """run() with `side`'s registry and tracer reset and its tracer
    recording; {"snapshot", "events"} of what it left, both reset after."""
    metrics, trace = OBSERVE[side]
    reset(side)
    path = os.path.join(directory, f"{side}.trace.json")
    trace.enable(path)
    try:
        run()
        snapshot = metrics.snapshot()
        trace.export(path)
    finally:
        reset(side)
    return {"snapshot": snapshot, "events": load_events(path)}
