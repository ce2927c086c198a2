"""Structured JSON logging with per-request correlation ids.

One JSON object per line, written to the sink :func:`enable` opens (a
file path, or ``stderr``). Every record carries:

* ``ts`` — epoch seconds (float),
* ``event`` — dotted event name ("serve.admitted", "frontier.chunk",
  "dispatch.flush", ...),
* ``cid`` — the correlation id in scope, or ``null`` outside a request,
* whatever keyword fields the call site attached.

The correlation id is minted at serve admission
(:func:`new_correlation_id`) and held in a ``contextvars.ContextVar``,
so everything the handling thread does downstream — frontier chunks,
dispatch flushes, the reply itself — inherits the same id without any
plumbing through call signatures. stdio/socket/HTTP transports all go
through ``AnalysisService.handle``, which scopes the id with
:func:`correlated`.

Design constraints mirror ``observe/trace.py``:

* **No-op when disabled.** :func:`event` is one attribute load + branch
  when the logger is off — it sits on the per-chunk frontier path and
  must stay inside the existing 5% telemetry overhead budget.
* **No knob.** The port reads no environment variable: the JAX
  package's ``MYTHRIL_TPU_SLOG`` is :func:`enable`'s argument.
* **Stdlib only.** No torch, no third-party logging stack.

The port's copy of mythril_tpu/observe/slog.py.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import sys
import threading
import time
import uuid
from typing import Optional

_CID: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "mythril_tpu_slog_cid", default=None)

_SEQ = itertools.count(1)


class _Slogger:
    """Process-wide structured logger singleton (module ``_SLOGGER``)."""

    def __init__(self):
        self.enabled = False
        self.sink_path: Optional[str] = None
        self._lock = threading.Lock()
        self._handle = None
        self._owns_handle = False

    def enable(self, sink: str) -> None:
        with self._lock:
            if self.enabled and self.sink_path == sink:
                return  # idempotent, like trace.enable
            self._close_locked()
            self.sink_path = sink
            if sink in ("stderr", "-"):
                self._handle = sys.stderr
                self._owns_handle = False
            else:
                self._handle = open(sink, "a", encoding="utf-8")
                self._owns_handle = True
            self.enabled = True

    def _close_locked(self) -> None:
        if self._handle is not None and self._owns_handle:
            try:
                self._handle.close()
            except OSError:
                pass
        self._handle = None
        self._owns_handle = False

    def reset(self) -> None:
        """Test hook: back to the never-touched state (sink closed)."""
        with self._lock:
            self.enabled = False
            self.sink_path = None
            self._close_locked()

    def emit(self, event_name: str, fields: dict) -> None:
        record = {"ts": round(time.time(), 6), "event": event_name,
                  "cid": _CID.get()}
        record.update(fields)
        line = json.dumps(record, sort_keys=True, default=repr)
        with self._lock:
            if not self.enabled or self._handle is None:
                return  # raced a reset(); drop silently
            try:
                self._handle.write(line + "\n")
                self._handle.flush()
            except (OSError, ValueError):
                # a dead sink must never take the engine down with it
                self.enabled = False


_SLOGGER = _Slogger()


def enabled() -> bool:
    """True when a sink is active."""
    return _SLOGGER.enabled


def enable(sink: str) -> None:
    """Open `sink` ('stderr', '-', or a file path) and start logging."""
    _SLOGGER.enable(sink)


def reset() -> None:
    _SLOGGER.reset()


def sink_path() -> Optional[str]:
    return _SLOGGER.sink_path


def event(event_name: str, **fields) -> None:
    """Write one structured record (no-op when disabled — one attribute
    load and a branch, cheap enough for per-chunk call sites)."""
    slogger = _SLOGGER
    if not slogger.enabled:
        return
    slogger.emit(event_name, fields)


def new_correlation_id() -> str:
    """Mint a fresh correlation id: short, unique within and across
    daemon processes (pid + 6 random hex + a process-local sequence)."""
    return f"c{os.getpid():x}-{uuid.uuid4().hex[:6]}-{next(_SEQ)}"


def correlation_id() -> Optional[str]:
    """The correlation id in scope (None outside a correlated block)."""
    return _CID.get()


class correlated:
    """Context manager scoping a correlation id over everything the
    current thread of execution does::

        with slog.correlated(slog.new_correlation_id()) as cid:
            ...  # frontier/dispatch slog records carry cid
    """

    __slots__ = ("cid", "_token")

    def __init__(self, cid: str):
        self.cid = cid

    def __enter__(self) -> str:
        self._token = _CID.set(self.cid)
        return self.cid

    def __exit__(self, *exc) -> bool:
        _CID.reset(self._token)
        return False
