"""AnalysisService: the daemon's request executor.

One instance owns the warm set, the admission queue, and the engine
lock; the stdio loop, the unix-socket server, and the HTTP shim all
funnel into :meth:`handle`, so every transport shares one behavior:

* **Admission** is a bounded two-class priority queue
  (serve/admission.py): ``max_inflight`` execution
  grants, up to ``queue_max`` waiting requests
  ordered (priority, deadline, arrival). Past the high-water mark the
  lowest-priority oldest waiter is shed with a typed ``overloaded``
  error carrying ``retry_after_ms``; a request whose deadline cannot
  be met given queue depth × observed p95 service time is refused at
  admission (early triage). Before any of that, a repeat
  (bytecode, config) request is answered straight from the
  content-addressed result store (serve/result_store.py) without
  consuming a grant or touching a worker.
* **Execution** is serialized on one engine lock — the symbolic engine,
  the solver pipeline, the dispatch queue and the card are all
  single-threaded process singletons (one thread launches on the card at
  a time, so no scrape can break a CUDA-graph capture). Admitted requests
  wait on the lock; the in-flight bound caps how many can wait.
* **Isolation**: each analyze request starts from
  ``reset_solver_backend(keep_verdicts=True)`` — fresh incremental
  pipeline, fresh breaker/fault state (a quarantine belongs to the
  request that suffered it), reset callback modules — while the
  canonical-CNF verdict cache and the loaded kernel libraries stay
  warm (that is the whole point of the daemon).
* **Deadlines** ride the engine's deadline-drain substrate: the
  request's ``deadline_ms`` becomes the analysis execution timeout, so
  an over-budget contract yields ``incomplete: true`` plus coverage
  stats, never a wedged queue.
* **Accounting**: every request runs inside a ``serve.request`` trace
  span carrying the request id and its warm/cold dispatch counts
  (``xla.bucket_compiles``/``bucket_reuses`` deltas), which is what
  ``tools/traceview.py``'s per-request rollup renders. In the port a
  reply's and ``/healthz``'s ``warm_hits`` count K11 chunks whose shape
  key had run before in the process (the warmup's included), and
  ``cold_buckets`` first runs of a key: neither says a capture or a
  compile was saved (serve/warmset.py).
* **Worker isolation** (``serve --workers N``): with a pool configured,
  the engine never runs in the
  daemon process — each analyze (or fleet micro-batch) is dispatched to
  a supervised, manifest-warmed worker process
  (serve/supervisor.py), so a segfault/OOM/hang kills one sandbox, the
  victim request is retried once, and repeat offenders land in the
  poison-quarantine sidecar (answered with a typed ``quarantined``
  error). The engine lock is bypassed in this mode: the pool itself is
  the execution-capacity gate (each worker is its own CUDA process on the
  one card). With ``workers_max`` set, an autoscaler (serve/autoscale.py) elastically resizes the pool
  from the admission-depth and occupancy gauges.
* **QoS preemption** (fleet mode): the micro-batcher composes batches
  in (priority, deadline, arrival) order, and an interactive arrival
  preempts a running all-bulk batch through the engine's per-contract
  deadline-drain machinery — the preempted members checkpoint
  (namespaced per contract) and re-run solo from their checkpoints
  instead of being aborted.
* **Graceful drain**: ``shutdown``/SIGTERM stops admission (typed
  ``shutting_down``), sheds queued bulk work, and gives in-flight and
  queued-interactive requests ``drain_ms`` to finish
  before the remaining fleet batches are preempted into checkpoints.

The port's copy of mythril_tpu/serve/service.py. Every knob the JAX
service reads is a keyword argument of :class:`AnalysisService` (and of
:func:`execution_timeout_s`) whose default is the knob's: the module
constants below, `admission.QUEUE_MAX`/`RETRY_AFTER_MS`,
`result_store.RESULT_STORE_MAX` and `warmset.VERDICT_SIDECAR_MAX`; the
worker heartbeat and the autoscaler's interval, which the JAX supervisor
and autoscaler read themselves, pass through to them
(`supervisor.HEARTBEAT_MS`, `autoscale.INTERVAL_MS`).
``engine="tpu"`` requests run `parallel/frontier.execute_message_call_tpu`
(K1-K10) and ``solver="jax"`` requests K11 on the devices that
`frontier.configure` and `dispatch.configure` name (the card by default);
without it the analyzer raises `DeviceUnavailable` and the request gets
the typed ``analysis_failed`` reply, never a host run in its place; a
request retried after a worker's death runs with its own engine and
solver (serve/worker.py).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, Optional

from . import protocol
from .admission import (QUEUE_MAX, RETRY_AFTER_MS, AdmissionQueue,
                        Overloaded)
from .autoscale import INTERVAL_MS
from .quarantine import QuarantinedContract, contract_key
from .result_store import (RESULT_STORE_MAX, ResultStore, result_key,
                           results_path_for)
from .supervisor import HEARTBEAT_MS
from .warmset import VERDICT_SIDECAR_MAX, WarmSet
from ..observe import export, metrics, slog, trace

log = logging.getLogger(__name__)

#: frontier telemetry counters rolled up per request and in /healthz
#: (declared in observe/metrics.py, fed by parallel/frontier.py's
#: per-chunk decode of the device counter plane)
_FRONTIER_COUNTERS = ("executed", "forks", "escapes", "reseeds", "deaths",
                      "cold_sload_pauses")


def _frontier_counters() -> Dict[str, int]:
    return {name: int(metrics.value(f"frontier.telemetry.{name}"))
            for name in _FRONTIER_COUNTERS}


#: the daemon's settings whose defaults are the JAX knobs'
#: (MYTHRIL_TPU_SERVE_MAX_INFLIGHT, SERVE_DRAIN_MS, SERVE_MAX_DEADLINE_MS,
#: FLEET_WINDOW_MS, FLEET_MAX_BATCH)
MAX_INFLIGHT = 4
DRAIN_MS = 5000
MAX_DEADLINE_MS = 86_400_000
FLEET_WINDOW_MS = 50.0
FLEET_MAX_BATCH = 8


def _shard_capacity_factor() -> int:
    """Shard count a fleet frontier would run with right now:
    `frontier.configure`'s forced ``fleet_shard`` when above 1, else (0)
    the card count when the frontier runs on the card and there are more
    than one (the rule `frontier.new_frontier` applies). The
    micro-batcher multiplies its per-batch capacity by it — N shard
    blocks sweep N contracts' lanes concurrently."""
    import torch

    from ..parallel import frontier

    forced = frontier._settings["fleet_shard"]
    if forced > 1:
        return forced
    if forced == 0 and frontier._settings["device"] in (None, "cuda") \
            and torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return torch.cuda.device_count()
    return 1


def _shard_rollup() -> Dict[str, object]:
    """Sharded-fleet gauges for /healthz (declared in observe/metrics.py,
    fed by the frontier's per-chunk shard-block decode)."""
    return {
        "devices": int(metrics.value("frontier.shard.devices")),
        "steal_rows": int(metrics.value("frontier.shard.steal_rows")),
        "steal_passes": int(metrics.value("frontier.shard.steal_passes")),
        "imbalance": int(metrics.value("frontier.shard.imbalance")),
        "fairness": float(metrics.value("frontier.shard.fairness")),
    }


def execution_timeout_s(deadline_ms: Optional[int],
                        max_ms: int = MAX_DEADLINE_MS) -> float:
    """A request's ``deadline_ms`` as the engine execution timeout in
    seconds, clamped to the ``max_ms`` ceiling; a request without a
    deadline gets the full ceiling (one day by default — "no deadline"
    still must not wedge a worker forever). Shared by the solo path, the
    fleet batcher, and the worker process, so every execution route
    prices a deadline the same way."""
    if deadline_ms:
        if max_ms and deadline_ms > max_ms:
            deadline_ms = max_ms
        return max(deadline_ms / 1000.0, 0.001)
    return max(max_ms / 1000.0, 0.001) if max_ms else 86400.0


class _RequestArgs:
    """Namespace handed to MythrilAnalyzer as cmd_args (it getattr()s
    every field with a default, so only overrides need to exist)."""


#: batch-composition order: priority class first, then deadline
_PRIORITY_RANK = {name: rank
                  for rank, name in enumerate(protocol.PRIORITIES)}


class _FleetTicket:
    """One analyze request waiting on (or leading) a fleet micro-batch."""

    _seq = itertools.count(1)

    def __init__(self, params: Dict, cid: str):
        self.params = params
        self.cid = cid
        self.seq = next(self._seq)
        self.done = threading.Event()
        self.payload: Optional[Dict] = None
        self.error: Optional[BaseException] = None
        #: set when this member was preempted by an interactive arrival:
        #: the request thread re-runs it solo from `resume_path`
        self.preempted = False
        self.resume_path: Optional[str] = None

    def sort_key(self):
        deadline = self.params.get("deadline_ms") or float("inf")
        return (_PRIORITY_RANK.get(
            self.params.get("priority") or "interactive", 0),
            deadline, self.seq)


class _FleetBatcher:
    """Micro-batching admission for `analyze` (opt-in: `serve --fleet`).

    Instead of queueing on the engine lock one-by-one, concurrent
    compatible requests form a batch: the first arrival for a parameter
    key becomes the LEADER, waits the service's ``fleet_window_ms`` for
    followers, then runs every member's contract as ONE fleet
    (MythrilAnalyzer.fleet_contract_results — one shared device frontier,
    merged solver flushes) and demuxes per-contract results back into
    per-request replies. Followers just park on their ticket. Requests
    whose parameters differ (another key) lead their own batch. Only the
    leader thread launches on the card (the fleet driver's token rule),
    and the leader changes from batch to batch, so nothing here keeps
    per-thread CUDA state.

    QoS: the leader composes the batch in (priority, deadline, arrival)
    order, and an interactive arrival at admission preempts any running
    all-bulk batch (``preempt_for_interactive``) via the engine's
    deadline-drain machinery — preempted members checkpoint under a
    batch-scoped namespace and their request threads re-run them solo
    from the checkpoint once the interactive work has the engine."""

    #: params that must agree for two requests to share one fleet step
    _KEY_FIELDS = ("engine", "solver", "strategy", "max_depth",
                   "transaction_count", "bin_runtime", "deadline_ms")

    def __init__(self, service: "AnalysisService"):
        self.service = service
        self._lock = threading.Lock()
        self._waiting: Dict[tuple, list] = {}
        self._batch_seq = itertools.count(1)
        #: running engine-lock batches: {"preempt": Event, "tickets": []}
        #: (worker-mode batches are not preemptible across the process
        #: boundary — the pool's parallelism is their QoS lever)
        self._inflight: list = []

    def _key(self, params: Dict) -> tuple:
        key = [params.get(field) for field in self._KEY_FIELDS]
        modules = params.get("modules")
        key.append(tuple(modules) if modules else None)
        return tuple(key)

    def run(self, params: Dict, cid: str) -> Dict:
        """Join (or lead) the micro-batch for this request's parameter
        key; returns this request's own payload."""
        window_s = max(self.service.fleet_window_ms, 0.0) / 1000.0
        max_batch = max(int(self.service.fleet_max_batch), 1)
        # a sharded fleet frontier sweeps one lane block per shard, so the
        # micro-batch capacity scales with the shard count (cards, or
        # frontier.configure's fleet_shard when forced)
        max_batch *= max(_shard_capacity_factor(), 1)
        key = self._key(params)
        ticket = _FleetTicket(params, cid)
        with self._lock:
            group = self._waiting.get(key)
            if group is not None and len(group) < max_batch:
                group.append(ticket)
                leader = False
            else:
                self._waiting[key] = [ticket]
                leader = True
        if leader:
            if window_s:
                time.sleep(window_s)
            with self._lock:
                group = self._waiting.pop(key)
            # batch composition is (priority, deadline, arrival), so a
            # mixed batch runs its interactive members first
            group.sort(key=_FleetTicket.sort_key)
            if self.service._supervisor is not None:
                # worker mode: the batch runs in a supervised worker
                # process; the pool is the capacity gate, not the
                # daemon's engine lock
                self._run_batch_workers(group)
            else:
                with self.service._engine_lock:
                    self._run_batch(group)
        ticket.done.wait()
        if ticket.preempted:
            return self._rerun_preempted(ticket)
        if ticket.error is not None:
            raise ticket.error
        return ticket.payload

    def preempt_for_interactive(self) -> int:
        """Preempt every running all-bulk batch (an interactive request
        just arrived and wants the engine): sets the batch's preempt
        event, so the next deadline-drain sweep abandons its members —
        they checkpoint and re-run solo. Returns batches preempted."""
        with self._lock:
            batches = list(self._inflight)
        hit = 0
        for batch in batches:
            if batch["preempt"].is_set():
                continue
            if all((t.params.get("priority") or "interactive") == "bulk"
                   for t in batch["tickets"]):
                batch["preempt"].set()
                hit += 1
                metrics.inc("serve.fleet.preempted")
                slog.event("serve.fleet.preempt",
                           members=len(batch["tickets"]))
                log.info("preempting a running bulk fleet batch "
                         "(%d member(s)) for an interactive arrival",
                         len(batch["tickets"]))
        return hit

    def _rerun_preempted(self, ticket: _FleetTicket) -> Dict:
        """The request thread's continuation after its member was
        preempted: one solo engine-lock run, resuming from the member's
        batch-scoped checkpoint when one was written (a drain before
        the first periodic save restarts from scratch). Solo means no
        batcher and no preempt event — a re-run cannot be preempted
        again, so bulk work always completes."""
        resume = ticket.resume_path
        if resume and not os.path.exists(resume):
            resume = None
        slog.event("serve.fleet.requeued", resume=bool(resume))
        try:
            with self.service._engine_lock:
                payload = self.service._run_analysis_local(
                    ticket.params, resume_path=resume)
        finally:
            if ticket.resume_path:
                try:
                    os.unlink(ticket.resume_path)
                except OSError:
                    pass
        payload["fleet_preempted"] = True
        return payload

    def _run_batch(self, group: list) -> None:
        """Leader-side: run every ticket's contract as one fleet and
        complete the tickets. Always completes every ticket (with an
        error when the batch itself fails) — followers must never hang."""
        try:
            self._run_batch_inner(group)
        except BaseException as error:  # noqa: BLE001 — demuxed per ticket
            for ticket in group:
                if not ticket.done.is_set():
                    ticket.error = error
                    ticket.done.set()
            raise

    def _run_batch_workers(self, group: list) -> None:
        """Leader-side, worker mode: quarantined members are refused
        individually (an innocent co-member must not lose its slot to a
        poison contract), then the surviving members ship to one worker
        as a single fleet job — death detection and retry are the
        supervisor's job. Always completes every ticket."""
        from . import quarantine
        from .supervisor import WorkerAnalysisError

        supervisor = self.service._supervisor
        live = []
        for ticket in group:
            try:
                supervisor._check_quarantine(
                    quarantine.contract_key(ticket.params.get("code")))
            except quarantine.QuarantinedContract as error:
                ticket.error = error
                ticket.done.set()
                continue
            live.append(ticket)
        if not live:
            return
        if len(live) >= 2:
            metrics.inc("serve.fleet.windows")
            metrics.inc("serve.fleet.batched", len(live))
            slog.event("serve.fleet.batch", requests=len(live),
                       workers=True)
        try:
            outcomes = supervisor.run_fleet(
                [ticket.params for ticket in live], cid=live[0].cid)
        except BaseException as error:  # noqa: BLE001 — demuxed per ticket
            for ticket in live:
                if not ticket.done.is_set():
                    ticket.error = error
                    ticket.done.set()
            raise
        for ticket, outcome in zip(live, outcomes):
            if isinstance(outcome, dict) and outcome.get("ok"):
                ticket.payload = outcome.get("payload") or {}
            else:
                outcome = outcome if isinstance(outcome, dict) else {}
                ticket.error = WorkerAnalysisError(
                    outcome.get("error_type", "Exception"),
                    outcome.get("error", "fleet member failed in worker"))
            ticket.done.set()

    def _run_batch_inner(self, group: list) -> None:
        from ..analysis.report import Report
        from ..analysis.security import reset_callback_modules
        from ..mythril import MythrilAnalyzer, MythrilDisassembler
        from ..smt.solver.solver import reset_solver_backend

        if len(group) >= 2:
            metrics.inc("serve.fleet.windows")
            metrics.inc("serve.fleet.batched", len(group))
            slog.event("serve.fleet.batch", requests=len(group))
        # one isolation reset per BATCH (the batch is the unit of engine
        # occupancy, exactly like one solo request on the legacy path)
        reset_solver_backend(keep_verdicts=True)
        reset_callback_modules()
        params = group[0].params
        preempt = threading.Event()
        ckpt_base = os.path.join(self.service._fleet_ckpt_dir(),
                                 f"fleet-{next(self._batch_seq)}")
        cmd = _RequestArgs()
        cmd.solver = params.get("solver") or self.service.solver
        cmd.engine = params.get("engine") or self.service.engine
        cmd.max_depth = params["max_depth"]
        cmd.fleet = True
        cmd.fleet_preempt = preempt
        # batch-scoped checkpoint namespace: each member periodically
        # saves to {base}.{contract_id}, which is exactly what a
        # preempted member's solo re-run resumes from
        cmd.checkpoint = ckpt_base
        cmd.execution_timeout = execution_timeout_s(
            params.get("deadline_ms"), self.service.max_deadline_ms)
        disassembler = MythrilDisassembler()
        address = None
        live: list = []
        for ticket in group:
            try:
                address, contract = disassembler.load_from_bytecode(
                    ticket.params["code"], ticket.params["bin_runtime"])
                self.service._seed_summary(contract)
                live.append((ticket, contract))
            except Exception as error:  # bad input fails ITS request only
                ticket.error = error
                ticket.done.set()
        if not live:
            return
        analyzer = MythrilAnalyzer(
            disassembler, cmd_args=cmd,
            strategy=params.get("strategy") or self.service.strategy,
            address=address)
        batch = {"preempt": preempt,
                 "tickets": [ticket for ticket, _ in live]}
        with self._lock:
            self._inflight.append(batch)
        try:
            results = analyzer.fleet_contract_results(
                modules=params.get("modules"),
                transaction_count=params["transaction_count"])
        finally:
            with self._lock:
                if batch in self._inflight:
                    self._inflight.remove(batch)
        preempted = preempt.is_set() \
            and not self.service.shutting_down.is_set()
        for (ticket, contract), entry in zip(live, results):
            if preempted and entry["timed_out"]:
                # preempted mid-flight: hand the member back to its own
                # request thread to re-run solo from its checkpoint —
                # re-enqueue, not abort
                ticket.preempted = True
                ticket.resume_path = f"{ckpt_base}.{entry['contract_id']}"
                ticket.done.set()
                continue
            report = Report(contracts=[contract],
                            exceptions=entry["exceptions"])
            report.source = [getattr(contract, "input_file", contract.name)]
            report.incomplete = entry["timed_out"]
            report.coverage = entry["coverage"]
            for issue in entry["issues"]:
                report.append_issue(issue)
            self.service._record_summary(contract)
            ticket.payload = {
                "issue_count": len(report.issues),
                "incomplete": bool(report.incomplete),
                "coverage": report.coverage or {},
                "report": json.loads(report.as_json()),
                "fleet_batched": len(results),
            }
            ticket.done.set()


class AnalysisService:
    """The daemon's request executor. Each keyword is a JAX knob, with
    its default: ``warmup`` MYTHRIL_TPU_SERVE_WARMUP, ``max_inflight``
    SERVE_MAX_INFLIGHT, ``fleet`` FLEET_SERVE, ``workers`` SERVE_WORKERS,
    ``inject_fault`` INJECT_FAULT, ``queue_max`` SERVE_QUEUE_MAX,
    ``retry_after_ms`` SERVE_RETRY_AFTER_MS, ``drain_ms`` SERVE_DRAIN_MS,
    ``max_deadline_ms`` SERVE_MAX_DEADLINE_MS, ``fleet_window_ms``
    FLEET_WINDOW_MS, ``fleet_max_batch`` FLEET_MAX_BATCH,
    ``result_store`` RESULT_STORE, ``result_store_max`` RESULT_STORE_MAX,
    ``verdict_sidecar`` VERDICT_SIDECAR, ``verdict_sidecar_max``
    VERDICT_SIDECAR_MAX, ``trace_out`` TRACE, ``workers_min``/
    ``workers_max`` SERVE_WORKERS_MIN/MAX, ``heartbeat_ms``
    SERVE_WORKER_HEARTBEAT_MS, ``autoscale_interval_ms``
    SERVE_AUTOSCALE_INTERVAL_MS. The pool's backoff and quarantine knobs
    and the autoscaler's other policy knobs are `Supervisor`'s and
    `Autoscaler`'s keyword arguments, at their defaults here."""

    def __init__(self, solver: str = "cdcl", engine: str = "host",
                 strategy: str = "bfs",
                 manifest_path: Optional[str] = None,
                 warmup: bool = True,
                 max_inflight: int = MAX_INFLIGHT,
                 fleet: bool = False,
                 workers: int = 0,
                 inject_fault: Optional[str] = None,
                 queue_max: int = QUEUE_MAX,
                 retry_after_ms: int = RETRY_AFTER_MS,
                 drain_ms: int = DRAIN_MS,
                 max_deadline_ms: int = MAX_DEADLINE_MS,
                 fleet_window_ms: float = FLEET_WINDOW_MS,
                 fleet_max_batch: int = FLEET_MAX_BATCH,
                 result_store: bool = True,
                 result_store_max: int = RESULT_STORE_MAX,
                 verdict_sidecar: bool = True,
                 verdict_sidecar_max: int = VERDICT_SIDECAR_MAX,
                 trace_out: Optional[str] = None,
                 workers_min: int = 0,
                 workers_max: int = 0,
                 heartbeat_ms: int = HEARTBEAT_MS,
                 autoscale_interval_ms: int = INTERVAL_MS):
        self.solver = solver
        self.engine = engine
        self.strategy = strategy
        self.fleet = bool(fleet)
        self.drain_ms = drain_ms
        self.max_deadline_ms = max_deadline_ms
        self.fleet_window_ms = fleet_window_ms
        self.fleet_max_batch = fleet_max_batch
        self.trace_out = trace_out
        self._fleet_batcher = _FleetBatcher(self) if self.fleet else None
        self.warmset = WarmSet(
            manifest_path, verdict_sidecar=verdict_sidecar,
            verdict_sidecar_max=verdict_sidecar_max,
            device_required=engine == "tpu" or solver == "jax")
        self.warmup_enabled = warmup
        self.max_inflight = max(1, max_inflight)
        self.workers = max(0, int(workers or 0))
        self._supervisor = None
        if self.workers > 0:
            from .supervisor import Supervisor

            self._supervisor = Supervisor(
                self.workers, manifest_path=manifest_path,
                solver=self.solver, engine=self.engine,
                strategy=self.strategy, warmup=self.warmup_enabled,
                inject_fault=inject_fault, heartbeat_ms=heartbeat_ms,
                max_deadline_ms=max_deadline_ms,
                verdict_sidecar=verdict_sidecar,
                verdict_sidecar_max=verdict_sidecar_max)
        self._admission = AdmissionQueue(self.max_inflight,
                                         capacity=queue_max,
                                         retry_after_ms=retry_after_ms)
        # the result sidecar lives beside the warmset manifest, so the
        # store follows the manifest: no manifest, no result store (a
        # memory-only cache would silently diverge between daemons)
        self.result_store: Optional[ResultStore] = None
        if manifest_path and result_store:
            self.result_store = ResultStore(
                path=results_path_for(manifest_path),
                max_entries=result_store_max,
                quarantine=(self._supervisor.quarantine
                            if self._supervisor is not None else None))
        self._autoscaler = None
        if self._supervisor is not None:
            from .autoscale import Autoscaler

            self._autoscaler = Autoscaler(self._supervisor,
                                          self._admission,
                                          minimum=workers_min,
                                          maximum=workers_max,
                                          interval_ms=autoscale_interval_ms)
        self._engine_lock = threading.Lock()
        self._fleet_workdir: Optional[str] = None
        self._started = time.monotonic()
        self._requests_done = 0
        self.shutting_down = threading.Event()

    # -- lifecycle ---------------------------------------------------------------------

    def startup(self) -> None:
        """Warm the solver buckets from the manifest (when enabled) and
        stamp the trace manifest. Runs before the first request."""
        # enable the span tracer now, not at first analyze: the warmup
        # span must land in the trace for traceview's serve rollup
        if self.trace_out and not trace.enabled():
            trace.enable(self.trace_out)
        trace.set_manifest(serve_solver=self.solver,
                           serve_engine=self.engine)
        if self._supervisor is not None:
            # worker mode: each worker pre-warms from the manifest at
            # spawn; warming the daemon process too would pay the
            # compile cliff twice for an engine that never runs here
            self._supervisor.start()
        elif self.warmup_enabled:
            self.warmset.warmup()
            self.warmset.record_observed()
        if self._autoscaler is not None:
            self._autoscaler.start()

    def close(self) -> None:
        """Stop what the constructor started (the worker pool's fork
        server) for a service that will not serve: a daemon whose card
        could not be resolved."""
        if self._supervisor is not None:
            self._supervisor.stop()

    def shutdown(self, drain_ms: Optional[int] = None) -> None:
        """Graceful drain, then stop: admission closes (new analyzes get
        ``shutting_down``), queued *bulk* work is shed, in-flight and
        queued-interactive requests get ``drain_ms`` (the service's
        unless given) to finish, and whatever is still running after the
        budget is preempted into its checkpoints instead of being cut."""
        if drain_ms is None:
            drain_ms = self.drain_ms
        self.shutting_down.set()
        if self._autoscaler is not None:
            self._autoscaler.stop()
        self._admission.close()
        shed = self._admission.shed_class("bulk")
        slog.event("serve.drain", drain_ms=drain_ms, bulk_shed=shed)
        drained = self._admission.wait_idle(max(0, drain_ms) / 1000.0)
        if not drained:
            log.warning("drain budget (%d ms) expired with work still "
                        "in flight — preempting into checkpoints",
                        drain_ms)
            if self._fleet_batcher is not None:
                with self._fleet_batcher._lock:
                    batches = list(self._fleet_batcher._inflight)
                for batch in batches:
                    batch["preempt"].set()
        if self._supervisor is not None:
            self._supervisor.stop()
        self.warmset.record_observed()
        trace.export()
        if self._fleet_workdir is not None:
            shutil.rmtree(self._fleet_workdir, ignore_errors=True)
            self._fleet_workdir = None

    def _fleet_ckpt_dir(self) -> str:
        if self._fleet_workdir is None:
            self._fleet_workdir = tempfile.mkdtemp(
                prefix="myth-tpu-torch-fleet-ckpt-")
        return self._fleet_workdir

    def uptime_s(self) -> float:
        return time.monotonic() - self._started

    # -- request handling --------------------------------------------------------------

    def handle(self, request) -> Dict:
        """One reply dict for one parsed request (or for the
        ProtocolError a transport's parser produced)."""
        if isinstance(request, protocol.ProtocolError):
            metrics.inc("serve.request_errors")
            return protocol.error_reply(request.request_id, request.code,
                                        request.message)
        if self.shutting_down.is_set() and request.op != "shutdown":
            return protocol.error_reply(request.id, "shutting_down",
                                        "daemon is draining")
        if request.op == "ping":
            return protocol.ok_reply(request.id, pong=True,
                                     uptime_s=round(self.uptime_s(), 3))
        if request.op == "healthz":
            return self._healthz(request)
        if request.op == "metrics":
            return self._metrics(request)
        if request.op == "status":
            return self._status(request)
        if request.op == "shutdown":
            self.shutting_down.set()
            return protocol.ok_reply(request.id, shutdown=True,
                                     requests_served=self._requests_done)
        # analyze/optimize: result-store short-circuit, then queued
        # admission, then execution. The correlation id is minted here,
        # at admission — a shed reply gets one too, so its log line and
        # reply still correlate.
        cid = slog.new_correlation_id()
        params = request.params
        priority = params.get("priority") or "interactive"
        cached = self._cached_reply(request, cid)
        if cached is not None:
            return cached
        if self._fleet_batcher is not None and priority == "interactive":
            # an interactive arrival evicts running all-bulk batches
            # BEFORE queueing, so the grant it waits on frees promptly
            self._fleet_batcher.preempt_for_interactive()
        try:
            self._admission.acquire(priority, params.get("deadline_ms"))
        except Overloaded as shed:
            with slog.correlated(cid):
                metrics.inc("serve.requests")
                metrics.inc("serve.busy_rejections")
                slog.event("serve.shed", request_id=str(request.id),
                           priority=priority, reason=shed.reason,
                           retry_after_ms=shed.retry_after_ms)
            code = ("shutting_down" if shed.reason == "shutting_down"
                    else "overloaded")
            reply = protocol.error_reply(request.id, code, str(shed))
            if code == "overloaded":
                reply["error"]["retry_after_ms"] = shed.retry_after_ms
            reply["correlation_id"] = cid
            return reply
        try:
            with slog.correlated(cid):
                slog.event("serve.admitted", request_id=str(request.id),
                           op=request.op, priority=priority)
                if request.op == "optimize":
                    # superopt rides the same admission queue and worker
                    # pool as analyze but never micro-batches: its own
                    # proof obligations already share one dispatch flush
                    if self._supervisor is not None:
                        return self._optimize(request, cid)
                    with self._engine_lock:
                        return self._optimize(request, cid)
                if self._fleet_batcher is not None and \
                        (params.get("engine") or self.engine) == "tpu":
                    # micro-batching path: the batch LEADER takes the
                    # engine lock for the whole fleet step; followers
                    # park on their ticket instead of queueing here
                    return self._analyze(request, cid, fleet=True)
                if self._supervisor is not None:
                    # worker mode: execution capacity is the pool, not
                    # the in-process engine — no engine lock, so two
                    # workers genuinely run two requests in parallel
                    return self._analyze(request, cid)
                with self._engine_lock:
                    return self._analyze(request, cid)
        finally:
            self._admission.release()

    def _cached_reply(self, request, cid: str) -> Optional[Dict]:
        """Content-addressed short-circuit: a repeat (bytecode, config)
        request is answered from the result store before admission —
        zero queueing, zero worker dispatch (the cheapest shedding)."""
        if self.result_store is None:
            return None
        params = request.params
        key = result_key(params, solver=self.solver, engine=self.engine,
                         strategy=self.strategy, op=request.op)
        payload = self.result_store.get(
            key, contract_hash=contract_key(params.get("code")))
        if payload is None:
            return None
        with slog.correlated(cid):
            metrics.inc("serve.requests")
            self._requests_done += 1
            slog.event("serve.reply", request_id=str(request.id),
                       ok=True, cached=True, op=request.op,
                       issues=payload.get("issue_count", 0))
        return protocol.ok_reply(request.id, correlation_id=cid,
                                 cached=True, elapsed_ms=0.0, **payload)

    def _healthz(self, request) -> Dict:
        """Liveness probe with a metrics summary (GET /healthz): uptime,
        request counters, warm-bucket totals, and the lifetime frontier
        telemetry rollup — a dashboard scrape's worth, without the full
        ``status`` payload (metrics snapshot, verdict cache)."""
        return protocol.ok_reply(
            request.id,
            healthy=True,
            uptime_s=round(self.uptime_s(), 3),
            requests_served=self._requests_done,
            busy_rejections=int(metrics.value("serve.busy_rejections")),
            request_errors=int(metrics.value("serve.request_errors")),
            warm={"cold_buckets": int(metrics.value("xla.bucket_compiles")),
                  "warm_hits": int(metrics.value("xla.bucket_reuses")),
                  "exec_hits": int(metrics.value("cache.exec.hits")),
                  "exec_misses": int(metrics.value("cache.exec.misses")),
                  "verdicts_loaded":
                      int(metrics.value("cache.verdict.loaded")),
                  "warmset": self.warmset.status()},
            frontier=_frontier_counters(),
            shard=_shard_rollup(),
            queue=self._admission.status(),
            autoscaler=(self._autoscaler.status()
                        if self._autoscaler is not None else None),
            result_store=(self.result_store.status()
                          if self.result_store is not None else None),
            workers=(self._supervisor.status()
                     if self._supervisor is not None else None))

    def _metrics(self, request) -> Dict:
        """Scrape (the `metrics` op / GET /metrics): the full registry
        as Prometheus text exposition plus the snapshot-ring tail.
        Handled *before* admission — a scrape during a long analyze
        (engine lock held) must answer immediately, never block."""
        metrics.inc("serve.metrics_scrapes")
        export.collect_device_memory()
        ring = export.ring()
        ring.record(scrape=str(request.id))
        return protocol.ok_reply(
            request.id,
            exposition=export.render_prometheus(),
            content_type=export.CONTENT_TYPE,
            ring={"capacity": ring.capacity, "entries": ring.tail(8)})

    def _status(self, request) -> Dict:
        from ..smt.solver import dispatch

        return protocol.ok_reply(
            request.id,
            uptime_s=round(self.uptime_s(), 3),
            requests_served=self._requests_done,
            solver=self.solver, engine=self.engine,
            fleet=self.fleet,
            max_inflight=self.max_inflight,
            queue=self._admission.status(),
            autoscaler=(self._autoscaler.status()
                        if self._autoscaler is not None else None),
            result_store=(self.result_store.status()
                          if self.result_store is not None else None),
            warmset=self.warmset.status(),
            workers=(self._supervisor.status()
                     if self._supervisor is not None else None),
            cached_verdicts=dispatch.cached_verdicts(),
            metrics=metrics.snapshot())

    def _analyze(self, request, cid: str, fleet: bool = False) -> Dict:
        params = request.params
        started = time.monotonic()
        cold_before = metrics.value("xla.bucket_compiles")
        warm_before = metrics.value("xla.bucket_reuses")
        exec_hits_before = metrics.value("cache.exec.hits")
        exec_misses_before = metrics.value("cache.exec.misses")
        frontier_before = _frontier_counters()
        with trace.span("serve.request", request_id=str(request.id),
                        correlation_id=cid) as span:
            try:
                if fleet:
                    payload = self._fleet_batcher.run(params, cid)
                else:
                    payload = self._run_analysis(params)
            except (KeyboardInterrupt, SystemExit):
                raise
            except QuarantinedContract as error:
                log.warning("refusing quarantined contract for request "
                            "%r: %s", request.id, error)
                metrics.inc("serve.requests")
                metrics.inc("serve.request_errors")
                span.set(error="quarantined")
                slog.event("serve.reply", request_id=str(request.id),
                           ok=False, error="quarantined")
                reply = protocol.error_reply(request.id, "quarantined",
                                             str(error))
                reply["correlation_id"] = cid
                return reply
            except Exception as error:
                log.exception("analysis failed for request %r", request.id)
                metrics.inc("serve.requests")
                metrics.inc("serve.request_errors")
                span.set(error=repr(error))
                slog.event("serve.reply", request_id=str(request.id),
                           ok=False, error=repr(error))
                reply = protocol.error_reply(
                    request.id, "analysis_failed",
                    f"{type(error).__name__}: {error}")
                reply["correlation_id"] = cid
                return reply
            cold = metrics.value("xla.bucket_compiles") - cold_before
            warm = metrics.value("xla.bucket_reuses") - warm_before
            exec_hits = metrics.value("cache.exec.hits") - exec_hits_before
            exec_misses = \
                metrics.value("cache.exec.misses") - exec_misses_before
            frontier = {name: value - frontier_before[name]
                        for name, value in _frontier_counters().items()}
            span.set(cold_buckets=cold, warm_hits=warm,
                     exec_hits=exec_hits, exec_misses=exec_misses,
                     issues=payload["issue_count"],
                     frontier_executed=frontier["executed"],
                     frontier_forks=frontier["forks"])
        elapsed_ms = (time.monotonic() - started) * 1000.0
        metrics.inc("serve.requests")
        metrics.observe("serve.request_ms", elapsed_ms)
        self._requests_done += 1
        if self.result_store is not None:
            # put() itself refuses incomplete payloads and quarantined
            # hashes — a deadline-drained partial must never be replayed
            self.result_store.put(
                result_key(params, solver=self.solver,
                           engine=self.engine, strategy=self.strategy),
                payload, contract_hash=contract_key(params.get("code")))
        self.warmset.record_observed()
        # one snapshot-ring tick per finished request: the "periodic"
        # cadence of a daemon is its request stream
        export.record_snapshot(request_id=str(request.id),
                               correlation_id=cid)
        slog.event("serve.reply", request_id=str(request.id), ok=True,
                   issues=payload["issue_count"],
                   elapsed_ms=round(elapsed_ms, 3),
                   cold_buckets=cold, warm_hits=warm,
                   exec_hits=exec_hits, exec_misses=exec_misses)
        return protocol.ok_reply(
            request.id,
            correlation_id=cid,
            elapsed_ms=round(elapsed_ms, 3),
            warm={"cold_buckets": cold, "warm_hits": warm,
                  "exec_hits": exec_hits, "exec_misses": exec_misses},
            frontier=frontier,
            **payload)

    def _run_analysis(self, params: Dict) -> Dict:
        """Route one request to the engine: in worker mode the supervisor
        dispatches it to a pooled sandbox process (with death detection,
        retry, and quarantine); otherwise it runs in-process."""
        if self._supervisor is not None:
            return self._supervisor.run_job(params,
                                            cid=slog.correlation_id())
        return self._run_analysis_local(params)

    def _run_analysis_local(self, params: Dict,
                            checkpoint_path: Optional[str] = None,
                            resume_path: Optional[str] = None) -> Dict:
        """The per-request engine run: isolate, load, fire lasers.
        `checkpoint_path`/`resume_path` are worker-mode extras: the
        request-scoped checkpoint the supervisor assigns so a killed
        worker's one retry can resume mid-analysis."""
        from ..analysis.security import reset_callback_modules
        from ..mythril import MythrilAnalyzer, MythrilDisassembler
        from ..smt.solver.solver import reset_solver_backend

        # fresh pipeline/breaker/clock per request; verdict cache and the
        # compiled executables survive (DispatchQueue.reset keep_verdicts)
        reset_solver_backend(keep_verdicts=True)
        reset_callback_modules()

        cmd = _RequestArgs()
        cmd.solver = params.get("solver") or self.solver
        cmd.engine = params.get("engine") or self.engine
        cmd.max_depth = params["max_depth"]
        cmd.execution_timeout = execution_timeout_s(params.get("deadline_ms"),
                                                    self.max_deadline_ms)
        if checkpoint_path:
            cmd.checkpoint = checkpoint_path
        if resume_path:
            cmd.resume = resume_path
        disassembler = MythrilDisassembler()
        address, contract = disassembler.load_from_bytecode(
            params["code"], params["bin_runtime"])
        self._seed_summary(contract)
        analyzer = MythrilAnalyzer(
            disassembler, cmd_args=cmd,
            strategy=params.get("strategy") or self.strategy,
            address=address)
        report = analyzer.fire_lasers(
            modules=params.get("modules"),
            transaction_count=params["transaction_count"])
        self._record_summary(contract)
        return {
            "issue_count": len(report.issues),
            "incomplete": bool(getattr(report, "incomplete", False)),
            "coverage": getattr(report, "coverage", {}) or {},
            "report": json.loads(report.as_json()),
        }

    def _optimize(self, request, cid: str) -> Dict:
        """The `optimize` op: gas superoptimization of one runtime
        bytecode, same accounting shell as `_analyze` (trace span,
        request metrics, result-store put under the op-discriminated
        key) around `superopt.optimize_bytecode`."""
        params = request.params
        started = time.monotonic()
        with trace.span("serve.request", request_id=str(request.id),
                        correlation_id=cid, op="optimize") as span:
            try:
                payload = self._run_optimize(params)
            except (KeyboardInterrupt, SystemExit):
                raise
            except QuarantinedContract as error:
                log.warning("refusing quarantined contract for request "
                            "%r: %s", request.id, error)
                metrics.inc("serve.requests")
                metrics.inc("serve.request_errors")
                span.set(error="quarantined")
                slog.event("serve.reply", request_id=str(request.id),
                           ok=False, error="quarantined")
                reply = protocol.error_reply(request.id, "quarantined",
                                             str(error))
                reply["correlation_id"] = cid
                return reply
            except Exception as error:
                log.exception("optimization failed for request %r",
                              request.id)
                metrics.inc("serve.requests")
                metrics.inc("serve.request_errors")
                span.set(error=repr(error))
                slog.event("serve.reply", request_id=str(request.id),
                           ok=False, error=repr(error))
                reply = protocol.error_reply(
                    request.id, "analysis_failed",
                    f"{type(error).__name__}: {error}")
                reply["correlation_id"] = cid
                return reply
            span.set(rewrites=len(payload.get("rewrites") or ()),
                     gas_saved=payload.get("gas_saved", 0))
        elapsed_ms = (time.monotonic() - started) * 1000.0
        metrics.inc("serve.requests")
        metrics.observe("serve.request_ms", elapsed_ms)
        self._requests_done += 1
        if self.result_store is not None:
            # keyed with op="optimize": an analyze verdict for the same
            # bytecode must never answer an optimize request (and vice
            # versa) — see result_store.result_key
            self.result_store.put(
                result_key(params, solver=self.solver,
                           engine=self.engine, strategy=self.strategy,
                           op="optimize"),
                payload, contract_hash=contract_key(params.get("code")))
        export.record_snapshot(request_id=str(request.id),
                               correlation_id=cid)
        slog.event("serve.reply", request_id=str(request.id), ok=True,
                   op="optimize",
                   rewrites=len(payload.get("rewrites") or ()),
                   gas_saved=payload.get("gas_saved", 0),
                   elapsed_ms=round(elapsed_ms, 3))
        return protocol.ok_reply(
            request.id,
            correlation_id=cid,
            elapsed_ms=round(elapsed_ms, 3),
            **payload)

    def _run_optimize(self, params: Dict) -> Dict:
        """Route one optimize request: worker mode dispatches to a
        pooled sandbox (death detection, retry, quarantine — same as
        analyze), otherwise it runs in-process."""
        if self._supervisor is not None:
            return self._supervisor.run_job(params,
                                            cid=slog.correlation_id(),
                                            kind="optimize")
        return self._run_optimize_local(params)

    def _run_optimize_local(self, params: Dict) -> Dict:
        """One in-process superopt run: same per-request isolation reset
        as analyze (fresh pipeline/breaker state, warm verdict cache and
        executables), then the engine walk + batched proofs."""
        from ..smt.solver.solver import reset_solver_backend
        from ..superopt import optimize_bytecode

        reset_solver_backend(keep_verdicts=True)
        report = optimize_bytecode(
            params["code"], solver=params.get("solver") or self.solver)
        return report.to_json()

    def _seed_summary(self, contract) -> None:
        """Pre-seed a persisted taint summary onto the contract's
        disassembly so a repeat corpus contract skips the fixpoint.
        Runtime code only — creation requests execute constructor code
        the summary never modeled."""
        if not getattr(contract, "code", None):
            return
        from ..staticanalysis import ContractSummary, install_summary

        cached = self.warmset.summary_for(contract.bytecode_hash)
        if cached is None:
            return
        summary = ContractSummary.from_json(cached)
        if summary is not None and summary.code_length * 2 == len(
                contract.code.removeprefix("0x")):
            install_summary(contract.disassembly, summary)
            metrics.inc("serve.summary_seeded")

    def _record_summary(self, contract) -> None:
        """Queue this contract's summary (fresh or seeded) for the
        warmset's summary store; flushed with the shape manifest."""
        if not getattr(contract, "code", None):
            return
        from ..staticanalysis import get_summary

        summary = get_summary(contract.disassembly)
        if summary is not None:
            self.warmset.record_summary(contract.bytecode_hash,
                                        summary.to_json())
