"""Supervisor for the serve worker-process pool.

The daemon process keeps protocol, admission, and metrics in-process;
the *engine* runs in supervised worker processes
(``python -m mythril_tpu_torch.serve.worker``, each its own CUDA process
on the one card) so one segfault, OOM kill, or wedged kernel takes down a
single request's sandbox instead of the
daemon, its warm caches, and every queued request (the Manticore /
DTVM sandbox argument, PAPERS.md). The supervisor owns:

* **The pool**: ``workers`` slots, each a warm worker
  that ran the warmset manifest at spawn. Dead slots respawn
  with exponential backoff (``backoff_ms``
  base, doubled per consecutive death, capped at 30 s).
* **Death detection + taxonomy**: a worker death is detected by pipe
  EOF (exit-status classified via ``resilience.classify_exit_status``:
  SIGSEGV/SIGBUS/SIGABRT → WORKER_SEGV, SIGKILL → WORKER_OOM) or by
  heartbeat timeout (``heartbeat_ms`` of
  silence → the supervisor kills the worker and classifies
  WORKER_HANG). Every death lands in ``serve.worker.deaths`` (labelled
  by class), a correlated slog record, and a trace instant.
* **Retry-once**: the victim request is retried on a fresh worker —
  resuming from its request-scoped host checkpoint when one was cut
  mid-flight, else restarting from the start with the request's own
  engine and solver. A second death fails the request with the typed
  worker exception instead of looping.
* **Quarantine**: each death is charged to the request's bytecode hash
  in the poison sidecar (serve/quarantine.py); once a contract reaches
  ``quarantine_after`` deaths it is refused at
  admission with a ``quarantined`` error — one bad contract can never
  crash-loop the pool.
* **Deterministic fault injection**: the supervisor holds a *private*
  ``FaultPlan`` (``serve --inject-fault worker_segv:2``) and visits
  the ``worker`` site once per
  dispatched job; a firing entry is embedded in the job and the worker
  genuinely dies that way. Private, because the engine-side plan is
  reset per request (``resilience.reset``), which would wipe a daemon-
  lifetime schedule.

The port's copy of mythril_tpu/serve/supervisor.py. The heartbeat,
backoff and quarantine settings are keyword defaults, the JAX knobs'
(MYTHRIL_TPU_SERVE_WORKER_HEARTBEAT_MS, SERVE_WORKER_BACKOFF_MS,
SERVE_QUARANTINE_AFTER). What the JAX supervisor hands its workers
through the environment is worker argv here: a worker reads no
environment, builds its service with no pool of its own, and exports no
trace or metrics snapshot (the daemon owns both); the deadline ceiling,
the verdict-sidecar settings and the daemon's structured-log sink are
flags. A worker runs the frontier and the SAT lane with their default
settings, on the card. A retry without a checkpoint is not moved to the
JAX supervisor's host ladder (engine=host, solver=cdcl): work asked of
the card stays on the card, and its job carries no ``ladder`` flag.
The pool's workers are forked by a fork server that has already imported
torch (serve/forkserver.py), which the supervisor starts when it is
built, not spawned as fresh interpreters: a spawn costs a fork and the
worker's CUDA context instead of torch's import. A ``worker_argv`` that
does not run the worker module is spawned with ``Popen`` as before.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import queue
import select
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import quarantine as quarantine_mod
from .warmset import VERDICT_SIDECAR_MAX
from ..observe import metrics, slog, trace
from ..support import resilience
from ..support.checkpoint import request_checkpoint_path

log = logging.getLogger(__name__)

#: the module a worker runs
WORKER_MODULE = "mythril_tpu_torch.serve.worker"
#: per-slot backoff ceiling — a permanently sick worker retries every
#: 30 s forever instead of growing an unbounded sleep
MAX_BACKOFF_S = 30.0
#: how long a spawned worker may take to warm up and report ready
READY_TIMEOUT_S = 600.0
#: silence after which a busy worker is killed as hung, ms
#: (MYTHRIL_TPU_SERVE_WORKER_HEARTBEAT_MS)
HEARTBEAT_MS = 30_000
#: base of a dead slot's respawn backoff, ms
#: (MYTHRIL_TPU_SERVE_WORKER_BACKOFF_MS)
BACKOFF_MS = 250
#: the deadline ceiling a worker prices requests with
#: (MYTHRIL_TPU_SERVE_MAX_DEADLINE_MS; service.MAX_DEADLINE_MS)
MAX_DEADLINE_MS = 86_400_000
#: how long run_job waits for a warm worker before giving up (covers
#: every slot being mid-backoff after a crash storm)
CHECKOUT_TIMEOUT_S = 600.0

WARM, BUSY, RESTARTING, BACKOFF, STOPPED = (
    "warm", "busy", "restarting", "backoff", "stopped")


class WorkerDeath(Exception):
    """Internal: one worker process died under a job."""

    def __init__(self, failure_class: str, detail: str = ""):
        self.failure_class = failure_class
        self.detail = detail
        super().__init__(f"{failure_class}: {detail}" if detail
                         else failure_class)


class WorkerAnalysisError(Exception):
    """An analysis exception *inside* a healthy worker (the sandbox
    survived; this is a clean per-request failure, never retried)."""

    def __init__(self, error_type: str, message: str):
        self.error_type = error_type
        super().__init__(f"{error_type}: {message}")


class WorkerUnavailable(Exception):
    """No warm worker could be checked out within the timeout."""


class _LineReader:
    """select()-driven line framing over a pipe fd. ``readline``
    returns a decoded line, ``""`` at EOF, or None on timeout — without
    a buffered wrapper that would hide pending lines from select()."""

    def __init__(self, fd: int):
        self.fd = fd
        self._buf = b""
        self._lines: deque = deque()
        self._eof = False

    def readline(self, timeout: float) -> Optional[str]:
        if self._lines:
            return self._lines.popleft()
        if self._eof:
            return ""
        try:
            ready, _, _ = select.select([self.fd], [], [], timeout)
        except (OSError, ValueError):
            self._eof = True
            return ""
        if not ready:
            return None
        try:
            chunk = os.read(self.fd, 1 << 16)
        except OSError:
            chunk = b""
        if not chunk:
            self._eof = True
            return ""
        self._buf += chunk
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            self._lines.append(line.decode("utf-8", "replace"))
        return self._lines.popleft() if self._lines else None


class _WorkerHandle:
    """One pool slot: the live process (if any) plus its lifecycle
    bookkeeping. State transitions are guarded by the supervisor lock."""

    def __init__(self, slot: int):
        self.slot = slot
        self.state = RESTARTING
        self.proc: Optional[subprocess.Popen] = None
        self.reader: Optional[_LineReader] = None
        self.pid: Optional[int] = None
        self.jobs_done = 0
        self.deaths = 0              # lifetime deaths on this slot
        self.consecutive_deaths = 0  # resets on a completed job
        self.restarts = 0

    def snapshot(self) -> dict:
        return {"slot": self.slot, "state": self.state, "pid": self.pid,
                "jobs_done": self.jobs_done, "deaths": self.deaths,
                "restarts": self.restarts}


class Supervisor:
    """Owns the worker pool for one :class:`AnalysisService`."""

    def __init__(self, workers: int,
                 manifest_path: Optional[str] = None,
                 solver: str = "cdcl", engine: str = "host",
                 strategy: str = "bfs", warmup: bool = True,
                 inject_fault: Optional[str] = None,
                 heartbeat_ms: int = HEARTBEAT_MS,
                 backoff_ms: int = BACKOFF_MS,
                 quarantine_path: Optional[str] = None,
                 quarantine_after: int = quarantine_mod.QUARANTINE_AFTER,
                 worker_argv: Optional[List[str]] = None,
                 max_deadline_ms: int = MAX_DEADLINE_MS,
                 verdict_sidecar: bool = True,
                 verdict_sidecar_max: int = VERDICT_SIDECAR_MAX):
        self.workers = max(1, int(workers))
        self.manifest_path = manifest_path
        self.solver = solver
        self.engine = engine
        self.strategy = strategy
        self.warmup = warmup
        self.max_deadline_ms = max_deadline_ms
        self.verdict_sidecar = verdict_sidecar
        self.verdict_sidecar_max = verdict_sidecar_max
        self.heartbeat_s = max(heartbeat_ms, 100) / 1000.0
        self.backoff_s = max(backoff_ms, 1) / 1000.0
        if quarantine_path is None and manifest_path:
            quarantine_path = quarantine_mod.quarantine_path_for(
                manifest_path)
        self.quarantine = quarantine_mod.QuarantineStore(
            quarantine_path, threshold=quarantine_after)
        # the supervisor's PRIVATE fault plan: the engine-side global
        # plan is reset per request, which would wipe a daemon-lifetime
        # injection schedule like worker_segv:2
        self._plan = resilience.FaultPlan(inject_fault)
        self._worker_argv = worker_argv
        self._lock = threading.Lock()
        self._idle: "queue.Queue[_WorkerHandle]" = queue.Queue()
        self._handles = [_WorkerHandle(slot)
                         for slot in range(self.workers)]
        self._slot_seq = itertools.count(self.workers)
        self._seq = itertools.count(1)
        self._stopping = threading.Event()
        self._workdir = tempfile.mkdtemp(prefix="myth-tpu-torch-serve-ckpt-")
        self._spawn_threads: List[threading.Thread] = []
        # started now, so that torch's import in the fork server overlaps
        # whatever the daemon does before its pool starts
        self._forks = None
        self._forks_lock = threading.Lock()
        if self._forked(self._worker_command()):
            self._forks = self._new_fork_server()

    # -- pool lifecycle ----------------------------------------------------------------

    def start(self) -> None:
        log.info("starting worker pool: %d worker(s), heartbeat %.1fs, "
                 "quarantine sidecar %s", self.workers, self.heartbeat_s,
                 self.quarantine.path)
        slog.event("serve.worker.pool_start", workers=self.workers,
                   heartbeat_s=self.heartbeat_s,
                   quarantine=self.quarantine.path)
        for handle in self._handles:
            self._respawn_async(handle, delay_s=0.0, restart=False)

    def stop(self) -> None:
        self._stopping.set()
        with self._lock:
            handles = list(self._handles)
        for handle in handles:
            proc = handle.proc
            handle.state = STOPPED
            if proc is None or proc.poll() is not None:
                continue
            try:
                proc.stdin.write(b'{"kind": "shutdown"}\n')
                proc.stdin.flush()
            except (OSError, ValueError):
                pass
            try:
                proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        for thread in self._spawn_threads:
            thread.join(timeout=1.0)
        while True:
            try:
                self._idle.get_nowait()
            except queue.Empty:
                break
        metrics.set_gauge("serve.worker.pool", 0)
        with self._forks_lock:
            if self._forks is not None:
                self._forks.close()
                self._forks = None
        shutil.rmtree(self._workdir, ignore_errors=True)
        slog.event("serve.worker.pool_stop", workers=self.workers)

    def _worker_command(self) -> List[str]:
        if self._worker_argv is not None:
            return list(self._worker_argv)
        argv = [sys.executable, "-m", WORKER_MODULE,
                "--solver", self.solver, "--engine", self.engine,
                "--strategy", self.strategy,
                "--heartbeat-ms", str(int(self.heartbeat_s * 1000)),
                "--max-deadline-ms", str(int(self.max_deadline_ms)),
                "--verdict-sidecar-max", str(int(self.verdict_sidecar_max))]
        if self.manifest_path:
            argv += ["--manifest", self.manifest_path]
        if not self.warmup:
            argv.append("--no-warmup")
        if not self.verdict_sidecar:
            argv.append("--no-verdict-sidecar")
        if slog.sink_path():
            argv += ["--slog", slog.sink_path()]
        return argv

    def _fork_server_command(self) -> List[str]:
        return [sys.executable, "-m", "mythril_tpu_torch.serve.forkserver"]

    def _new_fork_server(self):
        # imported here: the fork server's own process runs the module
        # as __main__, and may have imported this one first
        from .forkserver import ForkServer

        return ForkServer(self._fork_server_command())

    def _forked(self, argv: List[str]) -> bool:
        """Whether `argv` runs the worker module, so the fork server
        starts it."""
        return self._worker_argv is None \
            and argv[1:3] == ["-m", WORKER_MODULE]

    def _start_worker(self):
        """A new worker process: forked by the fork server (started
        again if it died), or `Popen` for another worker command."""
        argv = self._worker_command()
        if not self._forked(argv):
            return subprocess.Popen(argv, stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE, stderr=None,
                                    bufsize=0)
        with self._forks_lock:
            if self._stopping.is_set():
                raise OSError("the pool is stopping")
            if self._forks is None or self._forks.closed:
                self._forks = self._new_fork_server()
            forks = self._forks
        return forks.spawn(argv[3:])

    def _respawn_async(self, handle: _WorkerHandle, delay_s: float,
                       restart: bool) -> None:
        thread = threading.Thread(
            target=self._spawn_slot, args=(handle, delay_s, restart),
            name=f"serve-worker-spawn-{handle.slot}", daemon=True)
        self._spawn_threads = [t for t in self._spawn_threads
                               if t.is_alive()] + [thread]
        thread.start()

    def _spawn_slot(self, handle: _WorkerHandle, delay_s: float,
                    restart: bool) -> None:
        while not self._stopping.is_set():
            if delay_s > 0:
                with self._lock:
                    handle.state = BACKOFF
                slog.event("serve.worker.backoff", slot=handle.slot,
                           delay_s=round(delay_s, 3))
                if self._stopping.wait(delay_s):
                    return
            with self._lock:
                handle.state = RESTARTING
            spawned_at = time.monotonic()
            try:
                proc = self._start_worker()
            except OSError as error:
                if self._stopping.is_set():
                    return
                log.error("cannot spawn worker for slot %d: %s",
                          handle.slot, error)
                delay_s = min(max(delay_s, self.backoff_s) * 2,
                              MAX_BACKOFF_S)
                continue
            reader = _LineReader(proc.stdout.fileno())
            if self._await_ready(proc, reader, handle):
                with self._lock:
                    handle.proc = proc
                    handle.reader = reader
                    handle.pid = proc.pid
                    handle.state = WARM
                    if restart:
                        handle.restarts += 1
                metrics.inc("serve.worker.spawns")
                if restart:
                    metrics.inc("serve.worker.restarts")
                metrics.set_gauge("serve.worker.pool", self._live_count())
                slog.event("serve.worker.ready", slot=handle.slot,
                           pid=proc.pid, restart=restart,
                           spawn_s=round(time.monotonic() - spawned_at, 4))
                trace.instant("serve.worker.ready", slot=handle.slot,
                              pid=proc.pid)
                self._idle.put(handle)
                return
            # spawn failed (died or hung before ready): clean up, back
            # off, and try again — the slot must eventually come back
            if proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
            failure_class = resilience.classify_exit_status(
                proc.returncode) or resilience.WORKER_CRASH
            self._count_death(handle, failure_class,
                              f"died during startup (exit "
                              f"{proc.returncode})", job_id=None)
            restart = True
            delay_s = self._backoff_for(handle)

    def _await_ready(self, proc: subprocess.Popen, reader: _LineReader,
                     handle: _WorkerHandle) -> bool:
        deadline = time.monotonic() + READY_TIMEOUT_S
        while time.monotonic() < deadline and not self._stopping.is_set():
            line = reader.readline(timeout=0.5)
            if line is None:
                continue
            if line == "":
                return False
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if msg.get("event") == "ready":
                log.info("worker slot %d ready: pid %s, %s warm "
                         "bucket(s), %s executable-cache hit(s), %s "
                         "verdict(s) loaded", handle.slot, proc.pid,
                         msg.get("warmed", 0), msg.get("exec_hits", 0),
                         msg.get("verdicts_loaded", 0))
                self._fold_ready_metrics(msg)
                return True
        return False

    def _fold_ready_metrics(self, msg: dict) -> None:
        """Fold one worker's pre-warm deltas (shipped on its ready
        event) into the daemon's durable-warmth counters, so /healthz
        and /metrics report pool-wide deserialize-vs-compile coverage."""
        for name, value in (("cache.exec.hits", msg.get("exec_hits")),
                            ("cache.exec.misses",
                             msg.get("exec_misses")),
                            ("cache.verdict.loaded",
                             msg.get("verdicts_loaded"))):
            if isinstance(value, int) and value > 0:
                metrics.inc(name, value)

    def _live_count(self) -> int:
        with self._lock:
            return sum(1 for h in self._handles
                       if h.state in (WARM, BUSY))

    # -- elastic scaling ---------------------------------------------------------------

    def occupancy(self) -> Dict[str, int]:
        """Busy/live worker counts — the autoscaler's load signal."""
        with self._lock:
            busy = sum(1 for h in self._handles if h.state == BUSY)
            live = sum(1 for h in self._handles
                       if h.state in (WARM, BUSY))
        return {"busy": busy, "live": live}

    def scale_to(self, target: int) -> int:
        """Elastically resize the pool toward `target` slots (the
        autoscaler's lever). Growth spawns new slots immediately — they
        come up warm through the durable exec/verdict caches, not a
        cold compile. Shrink only retires *idle* workers: a busy worker
        is never killed mid-job, so when fewer idle workers are parked
        than the deficit, the remainder retires on a later tick.
        Returns the pool size after this call."""
        target = max(1, int(target))
        if self._stopping.is_set():
            return self.workers
        with self._lock:
            current = sum(1 for h in self._handles if h.state != STOPPED)
        while current < target:
            with self._lock:
                handle = _WorkerHandle(next(self._slot_seq))
                self._handles.append(handle)
            self._respawn_async(handle, delay_s=0.0, restart=False)
            current += 1
        while current > target:
            try:
                handle = self._idle.get_nowait()
            except queue.Empty:
                break  # nothing idle to retire — retry next tick
            if handle.proc is None or handle.proc.poll() is not None:
                # a corpse parked idle: retiring it IS the shrink —
                # count the death but do not respawn into a shrink
                self._count_death(handle,
                                  resilience.classify_exit_status(
                                      handle.proc.returncode
                                      if handle.proc else None)
                                  or resilience.WORKER_CRASH,
                                  "died while idle", job_id=None)
            self._retire(handle)
            current -= 1
        with self._lock:
            self.workers = max(
                1, sum(1 for h in self._handles if h.state != STOPPED))
            return self.workers

    def _retire(self, handle: _WorkerHandle) -> None:
        with self._lock:
            handle.state = STOPPED
            if handle in self._handles:
                self._handles.remove(handle)
            proc = handle.proc
            pid = handle.pid
            handle.proc = None
            handle.reader = None
            handle.pid = None
        if proc is not None and proc.poll() is None:
            try:
                proc.stdin.write(b'{"kind": "shutdown"}\n')
                proc.stdin.flush()
            except (OSError, ValueError):
                pass
            try:
                proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
        metrics.set_gauge("serve.worker.pool", self._live_count())
        slog.event("serve.worker.retired", slot=handle.slot, pid=pid)
        log.info("worker slot %d (pid %s) retired by scale-down",
                 handle.slot, pid)

    def _backoff_for(self, handle: _WorkerHandle) -> float:
        exponent = max(handle.consecutive_deaths - 1, 0)
        return min(self.backoff_s * (2 ** exponent), MAX_BACKOFF_S)

    # -- job execution -----------------------------------------------------------------

    def run_job(self, params: Dict, cid: Optional[str] = None,
                kind: str = "analyze") -> Dict:
        """Execute one analyze (or optimize) request in a worker, with
        quarantine admission, retry-once-on-death, and checkpoint
        resume. Returns the payload dict; raises QuarantinedContract,
        the typed worker failure after a double death, or
        WorkerAnalysisError for a clean in-worker exception."""
        key = quarantine_mod.contract_key(params.get("code"))
        self._check_quarantine(key)
        job_id = next(self._seq)
        checkpoint = request_checkpoint_path(
            self._workdir, f"{key[:12]}-{job_id}")
        job = {"kind": kind, "job_id": job_id, "params": params,
               "cid": cid, "checkpoint": checkpoint}
        try:
            try:
                return self._attempt(job)
            except WorkerDeath as death:
                self._record_crash(key, death)
                return self._retry(job, death, resume_from=checkpoint,
                                   quarantine_key=key)
        finally:
            try:
                os.unlink(checkpoint)
            except OSError:
                pass

    def run_fleet(self, members: List[Dict],
                  cid: Optional[str] = None) -> List[Dict]:
        """Execute one fleet micro-batch in a worker; returns one
        outcome dict per member ({"ok": true, "payload": ...} or
        {"ok": false, "error_type": ..., "error": ...}). Deaths retry
        the whole batch once on a fresh worker; crash accounting only
        charges a contract when it was alone in the batch (an innocent
        co-member must never inherit a poison record)."""
        key = (quarantine_mod.contract_key(members[0].get("code"))
               if len(members) == 1 else None)
        job = {"kind": "fleet", "job_id": next(self._seq),
               "members": members, "cid": cid}
        try:
            return self._attempt(job)["outcomes"]
        except WorkerDeath as death:
            if key is not None:
                self._record_crash(key, death)
            result = self._retry(job, death, resume_from=None,
                                 quarantine_key=key)
            return result["outcomes"]

    def _retry(self, job: Dict, death: WorkerDeath,
               resume_from: Optional[str],
               quarantine_key: Optional[str]) -> Dict:
        metrics.inc("serve.worker.retries")
        resuming = bool(resume_from and os.path.exists(resume_from))
        slog.event("serve.worker.retry", job_id=job["job_id"],
                   failure_class=death.failure_class, resume=resuming)
        log.warning("worker died under job %s (%s) — retrying on a "
                    "fresh worker (%s)", job["job_id"],
                    death.failure_class,
                    "checkpoint resume" if resuming else "from the start")
        retry = dict(job)
        retry["retry"] = True
        if resuming:
            retry["resume"] = resume_from
        try:
            return self._attempt(retry)
        except WorkerDeath as second:
            if quarantine_key is not None:
                self._record_crash(quarantine_key, second)
            exc_class = resilience._EXCEPTION_FOR_CLASS.get(
                second.failure_class, resilience.DeviceWorkerCrash)
            raise exc_class(
                f"worker died twice under this request "
                f"({death.failure_class}, then {second.failure_class}); "
                "giving up after one retry") from second

    def _check_quarantine(self, key: str) -> None:
        try:
            self.quarantine.check(key)
        except quarantine_mod.QuarantinedContract:
            metrics.inc("serve.worker.quarantine_refusals")
            slog.event("serve.quarantine.refused", contract=key[:16])
            raise

    def _record_crash(self, key: str, death: WorkerDeath) -> None:
        if self.quarantine.record_crash(key, death.failure_class):
            metrics.inc("serve.worker.quarantined")
            slog.event("serve.quarantine.added", contract=key[:16],
                       failure_class=death.failure_class)
            trace.instant("serve.quarantine.added", contract=key[:16])

    def _attempt(self, job: Dict) -> Dict:
        """One dispatch to one worker. Visits the supervisor's fault-
        injection site, so CLASS[:NTH] specs count dispatch attempts
        (retries included) across the whole pool."""
        handle = self._checkout()
        fired = self._plan.visit("worker")
        if fired is not None:
            job = dict(job)
            job["inject"] = fired
            log.warning("fault injection: job %s carries %s (visit %d "
                        "of site 'worker')", job["job_id"], fired,
                        self._plan.site_counts["worker"])
        return self._dispatch(handle, job)

    def _checkout(self) -> _WorkerHandle:
        deadline = time.monotonic() + CHECKOUT_TIMEOUT_S
        while time.monotonic() < deadline:
            try:
                handle = self._idle.get(timeout=1.0)
            except queue.Empty:
                if self._stopping.is_set():
                    break
                continue
            # a worker can die while parked idle — skip the corpse, its
            # slot's respawn is triggered by the dispatch failure path
            if handle.proc is not None and handle.proc.poll() is None:
                return handle
            self._on_death(handle,
                           resilience.classify_exit_status(
                               handle.proc.returncode if handle.proc
                               else None) or resilience.WORKER_CRASH,
                           "died while idle", job_id=None)
        raise WorkerUnavailable(
            f"no warm worker within {CHECKOUT_TIMEOUT_S:.0f}s "
            f"({self.workers} slot(s) configured)")

    def _dispatch(self, handle: _WorkerHandle, job: Dict) -> Dict:
        with self._lock:
            handle.state = BUSY
        try:
            handle.proc.stdin.write(
                (json.dumps(job, default=repr) + "\n").encode("utf-8"))
            handle.proc.stdin.flush()
        except (OSError, ValueError):
            return self._die(handle, job,
                             resilience.classify_exit_status(
                                 handle.proc.poll())
                             or resilience.WORKER_CRASH,
                             "worker pipe closed at dispatch")
        deadline = time.monotonic() + self.heartbeat_s
        while True:
            line = handle.reader.readline(timeout=0.25)
            if line is None:
                if time.monotonic() > deadline:
                    handle.proc.kill()
                    try:
                        handle.proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        pass
                    return self._die(
                        handle, job, resilience.WORKER_HANG,
                        f"no heartbeat for {self.heartbeat_s:.1f}s")
                continue
            if line == "":
                try:
                    handle.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    handle.proc.kill()
                    handle.proc.wait(timeout=5.0)
                returncode = handle.proc.returncode
                return self._die(
                    handle, job,
                    resilience.classify_exit_status(returncode)
                    or resilience.WORKER_CRASH,
                    f"exit status {returncode}")
            try:
                msg = json.loads(line)
            except ValueError:
                continue  # stray output; stdout is claimed, but be safe
            deadline = time.monotonic() + self.heartbeat_s
            if msg.get("event") != "result" or \
                    msg.get("job_id") != job["job_id"]:
                continue  # heartbeat, or a stale result from a past job
            with self._lock:
                handle.state = WARM
                handle.jobs_done += 1
                handle.consecutive_deaths = 0
            self._idle.put(handle)
            if not msg.get("ok"):
                raise WorkerAnalysisError(
                    msg.get("error_type", "Exception"),
                    msg.get("error", "analysis failed in worker"))
            payload = msg.get("payload") or {}
            self._fold_worker_metrics(payload.pop("serve_metrics", None))
            return payload

    def _die(self, handle: _WorkerHandle, job: Dict, failure_class: str,
             detail: str) -> Dict:
        """Common death path during a dispatch: account, respawn the
        slot, raise WorkerDeath for the retry layer."""
        self._on_death(handle, failure_class, detail,
                       job_id=job.get("job_id"))
        raise WorkerDeath(failure_class, detail)

    def _count_death(self, handle: _WorkerHandle, failure_class: str,
                     detail: str, job_id) -> None:
        """Death accounting only (no respawn): the caller owns the
        slot's recovery — _spawn_slot's own retry loop, or _on_death's
        _respawn_async."""
        with self._lock:
            handle.deaths += 1
            handle.consecutive_deaths += 1
            handle.state = RESTARTING
            pid = handle.pid
            handle.proc = None
            handle.reader = None
            handle.pid = None
        metrics.observe("serve.worker.deaths", 1, label=failure_class)
        metrics.set_gauge("serve.worker.pool", self._live_count())
        slog.event("serve.worker.death", slot=handle.slot, pid=pid,
                   failure_class=failure_class, detail=detail,
                   job_id=job_id)
        trace.instant("serve.worker.death", slot=handle.slot,
                      failure_class=failure_class, detail=detail)
        log.error("worker slot %d (pid %s) died: %s (%s)", handle.slot,
                  pid, failure_class, detail)

    def _on_death(self, handle: _WorkerHandle, failure_class: str,
                  detail: str, job_id) -> None:
        self._count_death(handle, failure_class, detail, job_id)
        if not self._stopping.is_set():
            self._respawn_async(handle, delay_s=self._backoff_for(handle),
                                restart=True)

    def _fold_worker_metrics(self, deltas: Optional[Dict]) -> None:
        """Fold the worker's warm/cold/frontier deltas into the daemon's
        own counters, so the per-request accounting in
        ``AnalysisService._analyze`` (and /healthz) keeps working across
        the process boundary."""
        if not isinstance(deltas, dict):
            return
        for name, value in (("xla.bucket_compiles",
                             deltas.get("cold_buckets")),
                            ("xla.bucket_reuses",
                             deltas.get("warm_hits")),
                            ("cache.exec.hits",
                             deltas.get("exec_hits")),
                            ("cache.exec.misses",
                             deltas.get("exec_misses"))):
            if value:
                metrics.inc(name, value)
        frontier = deltas.get("frontier")
        if isinstance(frontier, dict):
            for counter, value in frontier.items():
                name = f"frontier.telemetry.{counter}"
                if value and metrics.declared(name):
                    metrics.inc(name, value)

    # -- introspection -----------------------------------------------------------------

    def status(self) -> Dict:
        """The worker-pool rollup for /healthz, the ``status`` op, and
        the chaos harness: per-worker state, restart/death totals, and
        the quarantine census."""
        with self._lock:
            workers = [handle.snapshot() for handle in self._handles]
        return {
            "pool": self.workers,
            "live": sum(1 for w in workers
                        if w["state"] in (WARM, BUSY)),
            "restarts": sum(w["restarts"] for w in workers),
            "deaths": sum(w["deaths"] for w in workers),
            "workers": workers,
            "quarantine": self.quarantine.status(),
            "injection": self._plan.spec,
        }
