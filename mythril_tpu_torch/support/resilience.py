"""Failure domains, backend circuit breaker, and deterministic fault injection.

The solver stack degrades along a fixed ladder — device DPLL (`--solver jax`)
-> native CDCL -> pure-Python DPLL — and every rung decides the same
sat/unsat question, so a degraded run produces the same issues as a healthy
one, just slower (the DTVM determinism argument, PAPERS.md). This module
gives that ladder real failure domains instead of one blanket
`except Exception` counter:

- **Failure taxonomy**: every backend failure is classified (`classify_failure`)
  into one of `FAILURE_CLASSES` — device OOM, compile/trace error, wall-clock
  overrun, worker crash, verdict divergence, native crash — and counted
  per (backend, class) in `SolverStatistics.failure_counts`.
- **Circuit breaker** (`BackendHealth`): a backend that fails
  `trip_after` consecutive times is OPEN — skipped entirely, so a sick
  device stops paying minutes of XLA recompile per query. After
  `recovery_after` skipped queries one probe is let through (half-open);
  a probe success CLOSEs the breaker, a probe failure re-arms the skip
  window. A `DIVERGENCE` failure QUARANTINEs the backend for the rest of
  the process (no recovery probes): a backend that returned a *wrong*
  verdict can never be trusted again this run.
- **Fault injection** (`configure` / `fire` / `take`): the
  `--inject-fault CLASS[:NTH]` CLI flag raises the typed exception for CLASS at the NTH visit of its boundary —
  the device solve, the native solve, or the laser loop — so every ladder
  rung, the breaker thresholds, and the checkpoint/resume path are
  testable without real device failures.

State is process-global (like `SolverStatistics`); `reset()` restores a
pristine registry + plan and is called from
`smt.solver.solver.reset_solver_backend` so each fresh analysis (or test)
starts with healthy backends.

The port's copy of mythril_tpu/support/resilience.py. The JAX package reads
the breaker thresholds, the fault plan, the device wall budget and the
cross-check period from `MYTHRIL_TPU_*` variables; here they are
`configure(...)` arguments with the same defaults, and `reset()` restores
those. Its trace events go to the port's tracer (observe/trace.py).
"""

from __future__ import annotations

import logging
import signal
from typing import Callable, Dict, List, Optional, Tuple

from ..observe import trace

log = logging.getLogger(__name__)

# -- failure taxonomy -----------------------------------------------------------------

#: device ran out of HBM / host memory while solving
DEVICE_OOM = "device_oom"
#: XLA compile / trace / lowering error (bad shapes, tracer leaks, ...)
COMPILE_ERROR = "compile_error"
#: the solve exceeded its wall-clock budget (e.g. a recompile storm)
WALL_OVERRUN = "wall_overrun"
#: device/worker process died or any other unclassified backend error
WORKER_CRASH = "worker_crash"
#: backend returned a sat/unsat verdict the host oracle disproves
DIVERGENCE = "divergence"
#: native CDCL library failure (load error, session corruption, crash)
NATIVE_CRASH = "native_crash"
#: injection-only: simulated kill of the host laser loop (exercises the
#: checkpoint/resume path; never produced by classify_failure)
HOST_CRASH = "host_crash"
#: serve worker process died on a fatal signal (SIGSEGV/SIGBUS/SIGABRT)
WORKER_SEGV = "worker_segv"
#: serve worker process stopped heartbeating and had to be killed
WORKER_HANG = "worker_hang"
#: serve worker process was OOM-killed (SIGKILL) or raised MemoryError
WORKER_OOM = "worker_oom"

FAILURE_CLASSES = (DEVICE_OOM, COMPILE_ERROR, WALL_OVERRUN, WORKER_CRASH,
                   DIVERGENCE, NATIVE_CRASH, HOST_CRASH,
                   WORKER_SEGV, WORKER_HANG, WORKER_OOM)

#: backend names in ladder order (PYTHON is the floor: never gated)
DEVICE, NATIVE, PYTHON = "device", "native", "python"

# breaker states
CLOSED, OPEN, QUARANTINED = "closed", "open", "quarantined"


class BackendFailure(Exception):
    """Base of the typed failure exceptions (used by fault injection; real
    backend errors keep their original type and are mapped by
    classify_failure)."""

    failure_class = WORKER_CRASH


class DeviceOOM(BackendFailure):
    failure_class = DEVICE_OOM


class DeviceCompileError(BackendFailure):
    failure_class = COMPILE_ERROR


class DeviceWallOverrun(BackendFailure):
    failure_class = WALL_OVERRUN


class DeviceWorkerCrash(BackendFailure):
    failure_class = WORKER_CRASH


class NativeCrash(BackendFailure):
    failure_class = NATIVE_CRASH


class WorkerSegv(BackendFailure):
    failure_class = WORKER_SEGV


class WorkerHang(BackendFailure):
    failure_class = WORKER_HANG


class WorkerOOM(BackendFailure):
    failure_class = WORKER_OOM


class InjectedCrash(BaseException):
    """Simulated kill -9 of the analysis loop (`--inject-fault host_crash:N`).
    BaseException on purpose: it must sail through every `except Exception`
    (the analyzer's per-contract catch-all included) and unwind like a real
    death so the test can assert the run resumes from its last atomic
    checkpoint."""

    failure_class = HOST_CRASH


_EXCEPTION_FOR_CLASS = {
    DEVICE_OOM: DeviceOOM,
    COMPILE_ERROR: DeviceCompileError,
    WALL_OVERRUN: DeviceWallOverrun,
    WORKER_CRASH: DeviceWorkerCrash,
    NATIVE_CRASH: NativeCrash,
    HOST_CRASH: InjectedCrash,
    WORKER_SEGV: WorkerSegv,
    WORKER_HANG: WorkerHang,
    WORKER_OOM: WorkerOOM,
}

#: which injection boundary ("site") each failure class fires at
SITE_OF_CLASS = {
    DEVICE_OOM: DEVICE,
    COMPILE_ERROR: DEVICE,
    WALL_OVERRUN: DEVICE,
    WORKER_CRASH: DEVICE,
    DIVERGENCE: "divergence",
    NATIVE_CRASH: NATIVE,
    HOST_CRASH: "host",
    # worker classes fire at the serve supervisor's job-dispatch boundary
    # (serve/supervisor.py visits "worker" once per job handed to a
    # worker process; the worker then genuinely dies that way)
    WORKER_SEGV: "worker",
    WORKER_HANG: "worker",
    WORKER_OOM: "worker",
}

#: substrings of exception type names / messages that identify OOMs. XLA
#: surfaces device OOM as XlaRuntimeError("RESOURCE_EXHAUSTED: ...").
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "OOM",
                "Resource exhausted")
_COMPILE_TYPE_MARKERS = ("TracerError", "ConcretizationTypeError",
                         "UnexpectedTracerError", "JaxStackTraceBeforeTransformation",
                         "TypeError", "ShapeError")
_COMPILE_MSG_MARKERS = ("INVALID_ARGUMENT", "compilation", "lowering",
                        "abstract value", "jit")


def classify_failure(error: BaseException,
                     context: Optional[str] = None) -> str:
    """Map an arbitrary backend exception to a failure class. Typed
    injection exceptions carry their class; real errors classify by type
    and message shape, defaulting to WORKER_CRASH (the catch-all domain).

    ``context="worker"`` classifies on behalf of a serve worker process:
    memory exhaustion there is the worker's own failure domain
    (WORKER_OOM — the sandbox died, not the device), while the default
    context keeps the historical DEVICE_OOM mapping for in-process
    backend errors."""
    if isinstance(error, BackendFailure):
        return error.failure_class
    name = type(error).__name__
    text = f"{name}: {error}"
    if isinstance(error, MemoryError) or \
            any(marker in text for marker in _OOM_MARKERS):
        return WORKER_OOM if context == "worker" else DEVICE_OOM
    if isinstance(error, TimeoutError):
        return WALL_OVERRUN
    if any(marker in name for marker in _COMPILE_TYPE_MARKERS) or \
            any(marker in str(error) for marker in _COMPILE_MSG_MARKERS):
        return COMPILE_ERROR
    return WORKER_CRASH


#: fatal signals that mean "the process itself blew up" (not a kill)
_SEGV_SIGNALS = frozenset(
    getattr(signal, sig_name)
    for sig_name in ("SIGSEGV", "SIGBUS", "SIGABRT", "SIGILL", "SIGFPE")
    if hasattr(signal, sig_name))


def classify_exit_status(returncode: Optional[int]) -> Optional[str]:
    """Map a child process's ``Popen.returncode`` to a worker failure
    class, or None for a clean (or still-running) exit.

    Negative return codes are ``-signum`` (POSIX): SIGSEGV/SIGBUS/
    SIGABRT/SIGILL/SIGFPE classify as WORKER_SEGV (the process's own
    fault), SIGKILL as WORKER_OOM (the kernel OOM killer is the only
    expected uninvited SIGKILL source), anything else signal-ish or a
    non-zero exit as WORKER_CRASH."""
    if returncode is None or returncode == 0:
        return None
    if returncode < 0:
        signum = -returncode
        if signum in _SEGV_SIGNALS:
            return WORKER_SEGV
        if signum == getattr(signal, "SIGKILL", 9):
            return WORKER_OOM
        return WORKER_CRASH
    return WORKER_CRASH


# -- circuit breaker ------------------------------------------------------------------

#: consecutive failures before a backend trips OPEN
DEFAULT_TRIP_AFTER = 3
#: queries skipped while OPEN before one half-open recovery probe
DEFAULT_RECOVERY_AFTER = 32
#: wall budget (ms) of one device solve before it counts as WALL_OVERRUN
DEFAULT_DEVICE_WALL_MS = 120_000
#: re-decide every Nth device verdict on the host CDCL (0 = off)
DEFAULT_CROSSCHECK = 0

_DEFAULT_KNOBS = {"trip_after": DEFAULT_TRIP_AFTER,
                  "recovery_after": DEFAULT_RECOVERY_AFTER,
                  "device_wall_ms": DEFAULT_DEVICE_WALL_MS,
                  "crosscheck": DEFAULT_CROSSCHECK}
#: the knobs `configure` set last (the JAX package's environment knobs)
_knobs = dict(_DEFAULT_KNOBS)


def _stats():
    from ..smt.solver.solver_statistics import SolverStatistics

    return SolverStatistics()


class BackendHealth:
    """Per-backend failure bookkeeping + circuit breaker.

    States: CLOSED (healthy, queries flow), OPEN (tripped: queries are
    skipped, with a half-open probe every `recovery_after` skips),
    QUARANTINED (divergence: permanently off for this run). Every
    transition is mirrored into SolverStatistics so the final report can
    show the full fault story."""

    def __init__(self, name: str, trip_after: int = DEFAULT_TRIP_AFTER,
                 recovery_after: int = DEFAULT_RECOVERY_AFTER):
        self.name = name
        self.trip_after = trip_after
        self.recovery_after = recovery_after
        self.state = CLOSED
        self.consecutive_failures = 0
        self.skipped_since_trip = 0
        self.failure_counts: Dict[str, int] = {}
        self.trips = 0
        self.recoveries = 0
        self.last_failure: Optional[Tuple[str, str]] = None  # (class, detail)

    def allow(self) -> bool:
        """May the next query attempt this backend? OPEN breakers skip
        queries but let one probe through per recovery window."""
        if self.state == QUARANTINED:
            return False
        if self.state == OPEN:
            self.skipped_since_trip += 1
            if self.skipped_since_trip >= self.recovery_after:
                log.info("backend %r half-open: letting a recovery probe "
                         "through after %d skipped queries", self.name,
                         self.skipped_since_trip)
                return True
            return False
        return True

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state == OPEN:
            # a successful half-open probe recovers the backend
            self.state = CLOSED
            self.skipped_since_trip = 0
            self.recoveries += 1
            _stats().breaker_recoveries += 1
            trace.instant("resilience.breaker_recovery", backend=self.name)
            log.warning("backend %r recovered: circuit breaker closed",
                        self.name)

    def record_failure(self, failure_class: str, detail: str = "") -> None:
        self.failure_counts[failure_class] = \
            self.failure_counts.get(failure_class, 0) + 1
        self.consecutive_failures += 1
        self.last_failure = (failure_class, detail)
        stats = _stats()
        key = f"{self.name}:{failure_class}"
        stats.failure_counts[key] = stats.failure_counts.get(key, 0) + 1
        if failure_class == DIVERGENCE:
            self.quarantine(detail)
            return
        if self.state == OPEN:
            # failed recovery probe: re-arm the skip window
            self.skipped_since_trip = 0
            return
        if self.state == CLOSED and \
                self.consecutive_failures >= self.trip_after:
            self.state = OPEN
            self.skipped_since_trip = 0
            self.trips += 1
            stats.breaker_trips += 1
            trace.instant("resilience.breaker_trip", backend=self.name,
                          failure_class=failure_class,
                          consecutive=self.consecutive_failures)
            log.error(
                "backend %r circuit breaker TRIPPED after %d consecutive "
                "failures (last: %s %s) — degrading to the next ladder rung",
                self.name, self.consecutive_failures, failure_class, detail)

    def quarantine(self, detail: str = "") -> None:
        """Permanently disable the backend for this run (divergence: a
        backend that produced a wrong verdict cannot be probed back)."""
        if self.state == QUARANTINED:
            return
        self.state = QUARANTINED
        stats = _stats()
        if self.name not in stats.backends_quarantined:
            stats.backends_quarantined.append(self.name)
        trace.instant("resilience.quarantine", backend=self.name,
                      detail=detail or "verdict divergence")
        log.critical(
            "backend %r QUARANTINED for the rest of this run: %s — all "
            "further queries use the host ladder", self.name,
            detail or "verdict divergence")


class HealthRegistry:
    """Process-wide registry of BackendHealth objects (DEVICE / NATIVE;
    PYTHON is the unconditional floor and is never registered)."""

    def __init__(self):
        self._backends: Dict[str, BackendHealth] = {}

    def backend(self, name: str) -> BackendHealth:
        health = self._backends.get(name)
        if health is None:
            health = BackendHealth(name, trip_after=_knobs["trip_after"],
                                   recovery_after=_knobs["recovery_after"])
            self._backends[name] = health
        return health

    def states(self) -> Dict[str, str]:
        return {name: health.state
                for name, health in sorted(self._backends.items())}

    def reset(self) -> None:
        self._backends.clear()


registry = HealthRegistry()


# -- deterministic fault injection ----------------------------------------------------


def _parse_matcher(spec: str) -> Callable[[int], bool]:
    """"3" fires exactly at visit 3, "3+" from visit 3 on, "*" at every
    visit; an omitted NTH means "1"."""
    spec = spec.strip() or "1"
    if spec == "*":
        return lambda count: True
    if spec.endswith("+"):
        nth = int(spec[:-1])
        return lambda count: count >= nth
    nth = int(spec)
    return lambda count: count == nth


class FaultPlan:
    """Parsed `--inject-fault` spec: comma-separated CLASS[:NTH] entries.
    Each boundary visit increments a per-site counter; an entry fires when
    its matcher accepts the count — fully deterministic, no clocks."""

    def __init__(self, spec: Optional[str] = None):
        self.spec = spec
        #: (failure_class, site, matcher)
        self.entries: List[Tuple[str, str, Callable[[int], bool]]] = []
        self.site_counts: Dict[str, int] = {}
        self.fired: List[Tuple[str, int]] = []  # (class, visit) audit trail
        for raw_entry in (spec or "").split(","):
            raw_entry = raw_entry.strip()
            if not raw_entry:
                continue
            failure_class, _, nth = raw_entry.partition(":")
            failure_class = failure_class.strip()
            if failure_class not in SITE_OF_CLASS:
                raise ValueError(
                    f"unknown fault class {failure_class!r}; expected one of "
                    f"{sorted(SITE_OF_CLASS)}")
            self.entries.append((failure_class, SITE_OF_CLASS[failure_class],
                                 _parse_matcher(nth)))

    @property
    def active(self) -> bool:
        return bool(self.entries)

    def visit(self, site: str) -> Optional[str]:
        """Record a boundary visit; returns the failure class to fire (or
        None). At most one entry fires per visit (first match wins)."""
        if not self.entries:
            return None
        count = self.site_counts.get(site, 0) + 1
        self.site_counts[site] = count
        for failure_class, entry_site, matcher in self.entries:
            if entry_site == site and matcher(count):
                self.fired.append((failure_class, count))
                return failure_class
        return None


_plan = FaultPlan(None)


def configure(spec: Optional[str],
              trip_after: int = DEFAULT_TRIP_AFTER,
              recovery_after: int = DEFAULT_RECOVERY_AFTER,
              device_wall_ms: int = DEFAULT_DEVICE_WALL_MS,
              crosscheck: int = DEFAULT_CROSSCHECK) -> None:
    """Install a fault plan (None/empty disables injection) and the
    knobs the JAX package reads from its environment: the breaker
    thresholds of backends registered from now on, the device wall budget
    and the cross-check period. Also resets the plan's visit counters —
    each configure starts a fresh schedule."""
    global _plan
    _plan = FaultPlan(spec)
    _knobs.update(trip_after=trip_after, recovery_after=recovery_after,
                  device_wall_ms=device_wall_ms, crosscheck=crosscheck)
    if _plan.active:
        log.warning("fault injection ACTIVE: %s", spec)


def plan() -> FaultPlan:
    return _plan


def fire(site: str) -> None:
    """Raise the configured typed exception if an entry matches this visit
    of `site`. No-op (one dict lookup) when injection is inactive."""
    failure_class = plan().visit(site)
    if failure_class is not None:
        raise _EXCEPTION_FOR_CLASS[failure_class](
            f"injected {failure_class} (visit "
            f"{plan().site_counts[site]} of site {site!r})")


def take(site: str) -> bool:
    """Non-raising variant for verdict-mutation classes (divergence):
    True when this visit should fire."""
    return plan().visit(site) is not None


# -- knobs read by the solver stack ---------------------------------------------------


def device_wall_budget_ms() -> int:
    """Wall-clock budget for one device solve before it counts as a
    WALL_OVERRUN failure (0 disables the check). A sick backend often
    still answers — after minutes of recompile; overruns trip the breaker
    even when the verdict is usable."""
    return _knobs["device_wall_ms"]


def crosscheck_every() -> int:
    """Sampling period for the divergence cross-check: every Nth device
    verdict is re-decided by the host CDCL oracle (0 = off, the default).
    Set by `--device-crosscheck N` or `configure(..., crosscheck=N)`."""
    from .support_args import args

    configured = getattr(args, "device_crosscheck", 0)
    if configured:
        return int(configured)
    return _knobs["crosscheck"]


def reset() -> None:
    """Fresh registry + disarmed plan + default knobs (per-analysis /
    per-test isolation)."""
    global _plan
    registry.reset()
    _plan = FaultPlan(None)
    _knobs.update(_DEFAULT_KNOBS)
