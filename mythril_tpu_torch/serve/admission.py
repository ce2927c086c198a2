"""Admission control and backpressure for the serve daemon.

The original admission gate was a ``BoundedSemaphore`` that bounced any
request past ``max_inflight`` with a flat ``busy``. That fails the north
star two ways: a burst of bulk sweep traffic can starve the interactive
request that arrived a millisecond later, and a client has no idea
whether to retry in ten milliseconds or ten seconds.

:class:`AdmissionQueue` replaces it with a bounded two-class priority
queue:

* **Classes** — every request is ``interactive`` (the default) or
  ``bulk``; interactive always dequeues first, and within a class the
  earlier deadline wins, then arrival order (FIFO).
* **Backpressure** — up to ``capacity`` requests may
  wait. Past the high-water mark the *lowest-priority oldest* waiter is
  shed with a typed ``overloaded`` error carrying ``retry_after_ms``
  (the configured base plus observed p95 service time scaled by queue
  depth — an honest hint, not a constant). A flood of bulk work
  therefore sheds bulk work; an interactive request is only ever shed
  by other interactive requests.
* **Early deadline triage** — a request whose ``deadline_ms`` cannot be
  met given queue depth × observed p95 service time is refused at
  admission instead of burning a slot to produce a guaranteed-late
  answer. Triage needs evidence: with no completed requests yet (no
  p95), everything is admitted.
* **Drain** — at shutdown the daemon sheds queued bulk work (typed
  ``shutting_down``), stops new admission, and waits for in-flight and
  queued-interactive requests via :meth:`wait_idle`.

The queue hands out *execution grants*: ``acquire`` blocks the serving
thread until one of the ``slots`` (= ``--max-inflight``) grants is
free, then the caller runs the analysis and must ``release`` in a
``finally``. All scheduling state lives under one condition variable —
grants are handed to the best waiter by ``_pump`` whenever a slot
frees, so no thread can barge past the queue.

Stdlib-only (threading/time): imported by protocol-level tests without
paying an accelerator import.

The port's copy of mythril_tpu/serve/admission.py; the capacity and the
retry hint's base are keyword defaults, the JAX knobs'
(MYTHRIL_TPU_SERVE_QUEUE_MAX, MYTHRIL_TPU_SERVE_RETRY_AFTER_MS).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from .protocol import PRIORITIES

_RANK = {name: rank for rank, name in enumerate(PRIORITIES)}

#: p95 service-time source for deadline triage and retry hints
SERVICE_HISTOGRAM = "serve.request_ms"

#: waiting requests past which the queue sheds (MYTHRIL_TPU_SERVE_QUEUE_MAX)
QUEUE_MAX = 16
#: base of the retry hint, ms (MYTHRIL_TPU_SERVE_RETRY_AFTER_MS)
RETRY_AFTER_MS = 1000


class Overloaded(Exception):
    """A request refused or shed by admission control.

    ``reason`` is ``"overload"`` (queue past high-water mark),
    ``"deadline"`` (triage: cannot meet the deadline at current depth),
    or ``"shutting_down"`` (shed during drain). ``retry_after_ms`` is
    the client's backoff hint."""

    def __init__(self, message: str, retry_after_ms: int,
                 reason: str = "overload"):
        super().__init__(message)
        self.retry_after_ms = int(retry_after_ms)
        self.reason = reason


class _Waiter:
    __slots__ = ("priority", "rank", "deadline_ms", "seq", "enqueued_at",
                 "granted", "shed_reason", "retry_after_ms")

    def __init__(self, priority: str, deadline_ms: Optional[int], seq: int):
        self.priority = priority
        self.rank = _RANK[priority]
        self.deadline_ms = deadline_ms
        self.seq = seq
        self.enqueued_at = time.monotonic()
        self.granted = False
        self.shed_reason: Optional[str] = None
        self.retry_after_ms = 0

    def sort_key(self):
        deadline = self.deadline_ms if self.deadline_ms else float("inf")
        return (self.rank, deadline, self.seq)


class AdmissionQueue:
    """Bounded two-class priority admission queue (see module doc)."""

    def __init__(self, slots: int, capacity: int = QUEUE_MAX,
                 retry_after_ms: int = RETRY_AFTER_MS):
        self.slots = max(1, int(slots))
        self.capacity = max(1, int(capacity))
        self.retry_after_ms = max(1, int(retry_after_ms))
        self._cond = threading.Condition()
        self._waiters: list = []
        self._active = 0
        self._seq = 0
        self._closed = False
        self.shed_counts: Dict[str, int] = {name: 0 for name in PRIORITIES}
        self.deadline_rejections = 0

    # -- scheduling core (call with self._cond held) --------------------

    def _pump(self) -> None:
        """Hand free slots to the best waiters, best (rank, deadline,
        arrival) first."""
        handed = False
        while self._active < self.slots and self._waiters:
            best = min(self._waiters, key=_Waiter.sort_key)
            self._waiters.remove(best)
            best.granted = True
            self._active += 1
            handed = True
        if handed:
            self._cond.notify_all()

    def _gauge_depth(self) -> None:
        from ..observe import metrics

        metrics.set_gauge("serve.queue.depth", float(len(self._waiters)))

    def _p95_ms(self) -> Optional[float]:
        from ..observe import metrics

        try:
            p95 = metrics.quantile(SERVICE_HISTOGRAM, 0.95)
        except Exception:
            return None
        if p95 is None or p95 <= 0:
            return None
        return float(p95)

    def _retry_hint_ms(self, p95_ms: Optional[float]) -> int:
        """Backoff hint: base plus roughly one queue's worth of observed
        service time per slot — honest under load, minimal when idle."""
        hint = float(self.retry_after_ms)
        if p95_ms:
            depth = len(self._waiters) + 1
            hint += p95_ms * (depth / float(self.slots))
        return int(hint)

    def _shed(self, victim: "_Waiter", reason: str,
              retry_after_ms: int) -> None:
        from ..observe import metrics

        victim.shed_reason = reason
        victim.retry_after_ms = retry_after_ms
        self.shed_counts[victim.priority] += 1
        metrics.inc("serve.shed.overload")
        metrics.observe("serve.shed.by_class", 1.0, label=victim.priority)

    # -- public API -----------------------------------------------------

    def acquire(self, priority: str = "interactive",
                deadline_ms: Optional[int] = None) -> float:
        """Block until an execution grant is free; returns the time (ms)
        spent queued. Raises :class:`Overloaded` when this request is
        refused at triage, shed past the high-water mark, or shed by a
        drain."""
        from ..observe import metrics

        if priority not in _RANK:
            priority = "interactive"
        with self._cond:
            if self._closed:
                raise Overloaded("daemon is shutting down",
                                 self.retry_after_ms,
                                 reason="shutting_down")
            p95 = self._p95_ms()
            # early deadline triage: estimated completion is (everyone
            # queued ahead / slots + this request) p95 service times
            if deadline_ms and p95:
                est_ms = (len(self._waiters) / float(self.slots) + 1.0) * p95
                if est_ms > float(deadline_ms):
                    self.deadline_rejections += 1
                    metrics.inc("serve.shed.deadline")
                    raise Overloaded(
                        f"deadline {deadline_ms}ms cannot be met "
                        f"(estimated {int(est_ms)}ms at current depth)",
                        self._retry_hint_ms(p95), reason="deadline")
            self._seq += 1
            waiter = _Waiter(priority, deadline_ms, self._seq)
            self._waiters.append(waiter)
            if len(self._waiters) > self.capacity:
                # shed the lowest-priority oldest waiter — possibly the
                # newcomer itself if nothing queued outranks it
                victim = max(self._waiters,
                             key=lambda w: (w.rank, -w.seq))
                self._waiters.remove(victim)
                self._shed(victim, "overload", self._retry_hint_ms(p95))
                if victim is not waiter:
                    self._cond.notify_all()
            self._pump()
            self._gauge_depth()
            while not waiter.granted and waiter.shed_reason is None:
                self._cond.wait()
            self._gauge_depth()
            if waiter.shed_reason is not None:
                raise Overloaded("admission queue over capacity"
                                 if waiter.shed_reason == "overload"
                                 else "daemon is shutting down",
                                 waiter.retry_after_ms or self.retry_after_ms,
                                 reason=waiter.shed_reason)
            waited_ms = (time.monotonic() - waiter.enqueued_at) * 1000.0
        metrics.observe("serve.queue.wait_ms", waited_ms, label=priority)
        return waited_ms

    def release(self) -> None:
        with self._cond:
            if self._active > 0:
                self._active -= 1
            self._pump()
            self._gauge_depth()
            self._cond.notify_all()

    def try_acquire(self) -> bool:
        """Non-queueing grant for internal work (e.g. control ops that
        must not jump analyze traffic); False instead of waiting."""
        with self._cond:
            if self._closed or self._waiters or self._active >= self.slots:
                return False
            self._active += 1
            return True

    # -- drain ----------------------------------------------------------

    def close(self) -> None:
        """Stop admitting: subsequent ``acquire`` raises ``Overloaded``
        with reason ``shutting_down``. Queued waiters keep their place."""
        with self._cond:
            self._closed = True

    def shed_class(self, priority: str, reason: str = "shutting_down") -> int:
        """Shed every queued waiter of `priority` (drain path); returns
        how many were shed."""
        from ..observe import metrics

        with self._cond:
            victims = [w for w in self._waiters if w.priority == priority]
            for victim in victims:
                self._waiters.remove(victim)
                victim.shed_reason = reason
                victim.retry_after_ms = self.retry_after_ms
                self.shed_counts[victim.priority] += 1
                metrics.inc("serve.drain.shed")
            if victims:
                self._cond.notify_all()
            self._gauge_depth()
            return len(victims)

    def wait_idle(self, timeout_s: float) -> bool:
        """Wait up to `timeout_s` for every grant to be released and the
        queue to empty; True when fully idle."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            while self._active > 0 or self._waiters:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    # -- introspection ---------------------------------------------------

    def depths(self) -> Dict[str, int]:
        with self._cond:
            counts = {name: 0 for name in PRIORITIES}
            for waiter in self._waiters:
                counts[waiter.priority] += 1
            return counts

    def active(self) -> int:
        with self._cond:
            return self._active

    def status(self) -> dict:
        with self._cond:
            depths = {name: 0 for name in PRIORITIES}
            for waiter in self._waiters:
                depths[waiter.priority] += 1
            return {
                "slots": self.slots,
                "capacity": self.capacity,
                "active": self._active,
                "depth": depths,
                "shed": dict(self.shed_counts),
                "deadline_rejections": self.deadline_rejections,
                "closed": self._closed,
            }
