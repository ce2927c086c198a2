"""Serve worker process: the supervised analysis sandbox.

``python -m mythril_tpu_torch.serve.worker`` is spawned by the supervisor
(serve/supervisor.py), pre-warms from the warmset manifest, then loops
over JSON-lines jobs on stdin — one ``analyze``, one ``optimize``, or
one fleet micro-batch per job — writing JSON-lines events back on
stdout:

* ``{"event": "ready", "pid": ..., "warmed": N, "exec_hits": ...,
  "exec_misses": ..., "verdicts_loaded": ...}`` — once, after the
  pre-warm (the supervisor folds the durable-warmth counters — the
  kernel libraries found built or built, kernels/build.py — into
  the daemon's ``cache.exec.*`` / ``cache.verdict.*``);
* ``{"event": "heartbeat", "job_id": ...}`` — from a daemon thread
  while a job is running, so the supervisor can tell "slow" from
  "wedged" (a silent worker past the heartbeat timeout is killed and
  classified WORKER_HANG);
* ``{"event": "result", "job_id": ..., "ok": true, "payload": ...}`` or
  ``ok: false`` with ``error_type``/``error`` — an in-worker analysis
  exception is a *clean* failure (the sandbox survives; no retry), only
  a process death is a worker failure.

Stdout is reserved for this protocol: at startup the real stdout fd is
duplicated for the protocol writer and fd 1 is redirected to stderr, so
a chatty library can never corrupt the framing.

Jobs carry the request's correlation id across the process boundary:
the worker scopes ``slog.correlated(cid)`` around the run, and the slog
sink (``--slog``, the daemon's sink, opened append-mode) interleaves
supervisor and worker records under one cid.

Fault injection (``--inject-fault worker_*``) is decided by the
*supervisor* (its private FaultPlan visits the ``worker`` site once per
dispatched job); when a job arrives with ``"inject"`` set the worker
genuinely dies that way — SIGSEGV to itself for ``worker_segv``,
SIGKILL (the kernel OOM killer's signature) for ``worker_oom``, or
going silent for ``worker_hang`` — so the supervisor's detection,
classification, restart, retry, and quarantine paths are exercised end
to end, not simulated.

The port's copy of mythril_tpu/serve/worker.py: each worker is its own
CUDA process on the one card. What the JAX worker reads from the
environment its supervisor prepared is argv here (``--max-deadline-ms``,
``--verdict-sidecar-max``, ``--no-verdict-sidecar``, ``--slog``).

A retried job runs with the request's own engine and solver. The JAX
worker restarts a retry that has no checkpoint on the host ladder
(engine=host, solver=cdcl); the port does not, so that work asked of the
card never moves to the CPU after a death, and a result stored under a
card request's key is always the card's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time
from typing import TextIO

from ..observe import metrics, slog
from ..kernels import build
from ..support import resilience

log = logging.getLogger(__name__)


class _ProtocolWriter:
    """Line-framed JSON writer shared by the job loop and the heartbeat
    thread (one lock: a heartbeat must never tear a result line)."""

    def __init__(self, handle: TextIO):
        self._handle = handle
        self._lock = threading.Lock()

    def send(self, **record) -> None:
        line = json.dumps(record, sort_keys=True, default=repr)
        with self._lock:
            self._handle.write(line + "\n")
            self._handle.flush()


class _Heartbeat:
    """Emits ``heartbeat`` events for one job until stopped."""

    def __init__(self, writer: _ProtocolWriter, job_id: object,
                 interval_s: float):
        self._writer = writer
        self._job_id = job_id
        self._interval_s = max(interval_s, 0.05)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="worker-heartbeat", daemon=True)

    def __enter__(self) -> "_Heartbeat":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> bool:
        self._stop.set()
        self._thread.join(timeout=2.0)
        return False

    def _run(self) -> None:
        while not self._stop.wait(self._interval_s):
            self._writer.send(event="heartbeat", job_id=self._job_id)


def _self_destruct(failure_class: str) -> None:
    """Die the way the injected class says a worker dies. Never
    returns (except for unknown classes, which are ignored so a newer
    supervisor cannot wedge an older worker)."""
    log.warning("worker %d: injected %s — dying for real", os.getpid(),
                failure_class)
    slog.event("serve.worker.injected", failure_class=failure_class,
               pid=os.getpid())
    if failure_class == resilience.WORKER_SEGV:
        signal.signal(signal.SIGSEGV, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGSEGV)
    elif failure_class == resilience.WORKER_OOM:
        # the kernel OOM killer's signature: uncatchable SIGKILL
        os.kill(os.getpid(), signal.SIGKILL)
    elif failure_class == resilience.WORKER_HANG:
        # go silent: no heartbeat, no result — the supervisor's
        # heartbeat timeout must detect and kill us
        while True:
            time.sleep(3600)


def _run_analyze(service, job: dict) -> dict:
    from .service import _frontier_counters

    params = dict(job["params"])
    cold_before = metrics.value("xla.bucket_compiles")
    warm_before = metrics.value("xla.bucket_reuses")
    exec_hits_before = metrics.value("cache.exec.hits")
    exec_misses_before = metrics.value("cache.exec.misses")
    frontier_before = _frontier_counters()
    payload = service._run_analysis_local(
        params, checkpoint_path=job.get("checkpoint"),
        resume_path=job.get("resume"))
    payload["serve_metrics"] = {
        "cold_buckets": metrics.value("xla.bucket_compiles") - cold_before,
        "warm_hits": metrics.value("xla.bucket_reuses") - warm_before,
        "exec_hits": metrics.value("cache.exec.hits") - exec_hits_before,
        "exec_misses":
            metrics.value("cache.exec.misses") - exec_misses_before,
        "frontier": {name: value - frontier_before[name]
                     for name, value in _frontier_counters().items()},
    }
    return payload


def _run_optimize(service, job: dict) -> dict:
    """One gas-superoptimization job, no checkpoint — superopt runs are
    short and restartable."""
    return service._run_optimize_local(dict(job["params"]))


def _run_fleet(service, job: dict) -> dict:
    """One fleet micro-batch: reuses the in-process batcher's engine
    body (service._FleetBatcher._run_batch_inner) on supervisor-shipped
    member params, demuxed into per-member outcome dicts."""
    from .service import _FleetBatcher, _FleetTicket

    members = job.get("members") or []
    cid = job.get("cid") or ""
    group = []
    for params in members:
        group.append(_FleetTicket(dict(params), cid))
    if group:
        batcher = _FleetBatcher(service)
        try:
            batcher._run_batch_inner(group)
        except BaseException as error:  # noqa: BLE001 — demuxed per member
            for ticket in group:
                if not ticket.done.is_set():
                    ticket.error = error
                    ticket.done.set()
    outcomes = []
    for ticket in group:
        if ticket.error is not None:
            outcomes.append({"ok": False,
                             "error_type": type(ticket.error).__name__,
                             "error": str(ticket.error)})
        else:
            outcomes.append({"ok": True, "payload": ticket.payload})
    return {"outcomes": outcomes}


def _claim_stdout() -> TextIO:
    """Reserve the protocol channel: keep a private handle to the real
    stdout and point fd 1 (plus sys.stdout) at stderr so stray prints
    from the engine or its libraries cannot corrupt the framing."""
    protocol_out = os.fdopen(os.dup(sys.stdout.fileno()), "w",
                             encoding="utf-8")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    sys.stdout = sys.stderr
    return protocol_out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mythril_tpu_torch.serve.worker",
        description="supervised serve worker (spawned by the serve "
                    "supervisor; not a user-facing entry point)")
    parser.add_argument("--manifest", default=None)
    parser.add_argument("--solver", default="cdcl")
    parser.add_argument("--engine", default="host")
    parser.add_argument("--strategy", default="bfs")
    parser.add_argument("--no-warmup", action="store_true")
    parser.add_argument("--heartbeat-ms", type=int, default=30_000)
    parser.add_argument("--max-deadline-ms", type=int, default=86_400_000)
    parser.add_argument("--verdict-sidecar-max", type=int, default=65536)
    parser.add_argument("--no-verdict-sidecar", action="store_true")
    parser.add_argument("--slog", default=None, metavar="SINK")
    args = parser.parse_args(argv)
    if args.slog:
        slog.enable(args.slog)

    logging.basicConfig(
        stream=sys.stderr, level=logging.INFO,
        format=f"worker[{os.getpid()}] %(levelname)s %(name)s: %(message)s")
    writer = _ProtocolWriter(_claim_stdout())

    from .service import AnalysisService

    service = AnalysisService(
        solver=args.solver, engine=args.engine, strategy=args.strategy,
        manifest_path=args.manifest, warmup=False, max_inflight=1,
        fleet=False, workers=0, max_deadline_ms=args.max_deadline_ms,
        verdict_sidecar=not args.no_verdict_sidecar,
        verdict_sidecar_max=args.verdict_sidecar_max)
    warmed = 0
    if not args.no_warmup:
        warmed = service.warmset.warmup()
    # pre-warm accounting rides the ready event: the supervisor folds
    # these into the daemon's cache.exec.* / verdict counters, so
    # /healthz shows pool-wide durable-warmth coverage
    libraries = build.stats()
    writer.send(event="ready", pid=os.getpid(), warmed=warmed,
                exec_hits=libraries["hits"],
                exec_misses=libraries["misses"],
                verdicts_loaded=service.warmset.loaded_verdicts)
    log.info("worker ready (warmed %d buckets, %d kernel libraries found "
             "built, %d verdicts loaded)", warmed, libraries["hits"],
             service.warmset.loaded_verdicts)

    beat_s = max(args.heartbeat_ms, 200) / 4000.0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            job = json.loads(line)
        except ValueError:
            log.error("worker: unparseable job line %r — skipping",
                      line[:120])
            continue
        kind = job.get("kind")
        if kind == "shutdown":
            break
        job_id = job.get("job_id")
        inject = job.get("inject")
        if inject:
            _self_destruct(inject)
        with slog.correlated(job.get("cid") or ""):
            slog.event("serve.worker.job", job_id=job_id, kind=kind,
                       pid=os.getpid(), retry=bool(job.get("retry")))
            with _Heartbeat(writer, job_id, beat_s):
                try:
                    if kind == "fleet":
                        payload = _run_fleet(service, job)
                    elif kind == "optimize":
                        payload = _run_optimize(service, job)
                    else:
                        payload = _run_analyze(service, job)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as error:
                    log.exception("worker: job %s failed cleanly", job_id)
                    writer.send(event="result", job_id=job_id, ok=False,
                                error_type=type(error).__name__,
                                error=str(error))
                else:
                    writer.send(event="result", job_id=job_id, ok=True,
                                payload=payload)
        try:
            service.warmset.record_observed()
        except Exception:  # persistence is best-effort inside a worker
            log.exception("worker: could not persist warmset observations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
