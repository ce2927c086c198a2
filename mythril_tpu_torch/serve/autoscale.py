"""Elastic autoscaling for the serve worker pool.

A fixed pool wastes accelerator RAM when traffic is quiet and queues
requests when it spikes; the autoscaler closes the loop between the
load signals the daemon already exports and the supervisor's pool size:

* **Signals** — admission-queue depth (serve/admission.py ``depths``)
  and pool occupancy (supervisor ``occupancy``: busy vs live workers).
* **Policy** — hysteresis on consecutive ticks, not instantaneous
  state, so one bursty arrival cannot thrash the pool: scale **up** one
  worker after ``up_after`` consecutive
  *backlogged* ticks (requests queued while every live worker is busy),
  scale **down** one worker after the much longer
  ``down_after`` consecutive *idle* ticks
  (empty queue, zero busy workers). Up is eager and down is reluctant —
  shedding a request costs more than an idle worker.
* **Bounds** — the target stays in
  [``minimum`` (0 → the configured pool size),
  ``maximum``]; ``maximum=0`` (the default)
  disables autoscaling entirely and the pool stays fixed.
* **Lever** — ``Supervisor.scale_to``: growth spawns slots that come up
  warm through the built kernel libraries and the verdict sidecar;
  shrink only retires idle workers, so the target is re-asserted every
  tick until the pool converges.

Every decision lands in ``serve.autoscale.target`` (gauge) and
``serve.autoscale.scale_ups`` / ``scale_downs`` (counters), a slog
event, and the rollup ``status()`` block surfaced by /healthz and the
``status`` op.

The port's copy of mythril_tpu/serve/autoscale.py; the bounds and the
policy are keyword defaults, the JAX knobs' (MYTHRIL_TPU_SERVE_WORKERS_MIN,
SERVE_WORKERS_MAX, SERVE_AUTOSCALE_INTERVAL_MS, SERVE_AUTOSCALE_UP_AFTER,
SERVE_AUTOSCALE_DOWN_AFTER).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)

#: the policy's defaults (MYTHRIL_TPU_SERVE_AUTOSCALE_INTERVAL_MS, _UP_AFTER,
#: _DOWN_AFTER)
INTERVAL_MS = 500
UP_AFTER = 2
DOWN_AFTER = 8


class Autoscaler:
    """Hysteresis controller between admission depth and pool size."""

    def __init__(self, supervisor, admission,
                 minimum: int = 0,
                 maximum: int = 0,
                 interval_ms: int = INTERVAL_MS,
                 up_after: int = UP_AFTER,
                 down_after: int = DOWN_AFTER):
        self.supervisor = supervisor
        self.admission = admission
        base = supervisor.workers if supervisor is not None else 1
        self.minimum = max(1, int(minimum) if minimum else base)
        self.maximum = int(maximum)
        self.interval_s = max(int(interval_ms), 50) / 1000.0
        self.up_after = max(1, int(up_after))
        self.down_after = max(1, int(down_after))
        self.enabled = (supervisor is not None and admission is not None
                        and self.maximum > 0
                        and self.maximum > self.minimum)
        self.target = min(max(base, self.minimum),
                          self.maximum) if self.enabled else base
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_event: Optional[dict] = None
        self._backlog_ticks = 0
        self._idle_ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        from ..observe import metrics, slog

        metrics.set_gauge("serve.autoscale.target", float(self.target))
        slog.event("serve.autoscale.start", minimum=self.minimum,
                   maximum=self.maximum, interval_s=self.interval_s,
                   up_after=self.up_after, down_after=self.down_after)
        log.info("autoscaler on: pool [%d, %d], tick %.2fs, up after "
                 "%d backlogged tick(s), down after %d idle tick(s)",
                 self.minimum, self.maximum, self.interval_s,
                 self.up_after, self.down_after)
        self._thread = threading.Thread(target=self._run,
                                        name="serve-autoscaler",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("autoscaler tick failed")

    # -- control loop ---------------------------------------------------

    def tick(self) -> None:
        """One control decision (public so tests drive it without the
        timer thread)."""
        from ..observe import metrics, slog

        depths = self.admission.depths()
        depth = sum(depths.values())
        occ = self.supervisor.occupancy()
        backlogged = depth > 0 and occ["busy"] >= occ["live"]
        idle = depth == 0 and occ["busy"] == 0
        if backlogged:
            self._backlog_ticks += 1
            self._idle_ticks = 0
        elif idle:
            self._idle_ticks += 1
            self._backlog_ticks = 0
        else:
            self._backlog_ticks = 0
            self._idle_ticks = 0
        if (self._backlog_ticks >= self.up_after
                and self.target < self.maximum):
            self.target += 1
            self.scale_ups += 1
            self._backlog_ticks = 0
            metrics.inc("serve.autoscale.scale_ups")
            self.last_event = {"dir": "up", "to": self.target,
                               "at": time.time(), "depth": depth,
                               "busy": occ["busy"]}
            slog.event("serve.autoscale.up", target=self.target,
                       depth=depth, busy=occ["busy"], live=occ["live"])
            log.info("autoscale up -> %d worker(s) (depth %d, %d/%d "
                     "busy)", self.target, depth, occ["busy"],
                     occ["live"])
        elif (self._idle_ticks >= self.down_after
                and self.target > self.minimum):
            self.target -= 1
            self.scale_downs += 1
            self._idle_ticks = 0
            metrics.inc("serve.autoscale.scale_downs")
            self.last_event = {"dir": "down", "to": self.target,
                               "at": time.time(), "depth": depth,
                               "busy": occ["busy"]}
            slog.event("serve.autoscale.down", target=self.target,
                       depth=depth, busy=occ["busy"], live=occ["live"])
            log.info("autoscale down -> %d worker(s)", self.target)
        metrics.set_gauge("serve.autoscale.target", float(self.target))
        # re-assert every tick: shrink can only retire idle workers, so
        # the pool may converge to the target over several ticks
        self.supervisor.scale_to(self.target)

    # -- introspection --------------------------------------------------

    def status(self) -> dict:
        occ = (self.supervisor.occupancy()
               if self.supervisor is not None else {"busy": 0, "live": 0})
        return {
            "enabled": self.enabled,
            "min": self.minimum,
            "max": self.maximum,
            "target": self.target,
            "current": occ["live"],
            "busy": occ["busy"],
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "last_event": self.last_event,
        }
