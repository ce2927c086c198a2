"""The port's worker pool against the JAX package's: the death, hang,
retry, backoff, quarantine and socket-reclaim cases of
tests/test_worker_isolation.py, run on both packages' `Supervisor` and
`AnalysisService` with tests/_fake_worker.py (which imports neither
package) as the worker, through `worker_argv`; each case's outcome,
metric values and pool status (pids aside) are equal on both sides.
Also the port's `execution_timeout_s` and death taxonomy against the JAX
package's."""

import json
import os
import signal
import socket
import sys
import threading
from types import SimpleNamespace

import pytest

from mythril_tpu.observe import export as jexport
from mythril_tpu.observe import metrics as jmetrics
from mythril_tpu.observe import slog as jslog
from mythril_tpu.observe import trace as jtrace
from mythril_tpu.serve import client as jclient
from mythril_tpu.serve import daemon as jdaemon
from mythril_tpu.serve import protocol as jprotocol
from mythril_tpu.serve import quarantine as jquarantine
from mythril_tpu.serve import service as jservice
from mythril_tpu.serve import supervisor as jsupervisor
from mythril_tpu.support import resilience as jresilience
from mythril_tpu_torch.observe import export as pexport
from mythril_tpu_torch.observe import metrics as pmetrics
from mythril_tpu_torch.observe import slog as pslog
from mythril_tpu_torch.observe import trace as ptrace
from mythril_tpu_torch.serve import client as pclient
from mythril_tpu_torch.serve import daemon as pdaemon
from mythril_tpu_torch.serve import protocol as pprotocol
from mythril_tpu_torch.serve import quarantine as pquarantine
from mythril_tpu_torch.serve import service as pservice
from mythril_tpu_torch.serve import supervisor as psupervisor
from mythril_tpu_torch.support import resilience as presilience

FAKE_WORKER = [sys.executable,
               os.path.join(os.path.dirname(__file__), "_fake_worker.py")]

SIDES = {
    "jax": SimpleNamespace(
        supervisor=jsupervisor, service=jservice, protocol=jprotocol,
        quarantine=jquarantine, resilience=jresilience, daemon=jdaemon,
        client=jclient, metrics=jmetrics,
        observe=(jmetrics, jtrace, jslog, jexport)),
    "port": SimpleNamespace(
        supervisor=psupervisor, service=pservice, protocol=pprotocol,
        quarantine=pquarantine, resilience=presilience, daemon=pdaemon,
        client=pclient, metrics=pmetrics,
        observe=(pmetrics, ptrace, pslog, pexport)),
}


def _reset(side) -> None:
    metrics, trace, slog, export = side.observe
    metrics.reset()
    trace.reset()
    slog.reset()
    export.reset_ring()


def _supervisor(side, tmp_path, **overrides):
    workers = overrides.pop("workers", 1)
    defaults = dict(
        manifest_path=str(tmp_path / "warmset.json"),
        worker_argv=FAKE_WORKER, heartbeat_ms=2000, backoff_ms=10,
        quarantine_after=2)
    defaults.update(overrides)
    return side.supervisor.Supervisor(workers, **defaults)


def _settle(sup) -> None:
    """Wait (10 s at most) until every slot holds a live worker. A slot
    whose worker died is first in backoff (`backoff_ms` doubled a
    consecutive death), then restarting until the new worker reports
    ready: which of the two a read right after a case sees depends on how
    long the case's own return took, so the pool is read once settled."""
    deadline = 200
    while sup.status()["live"] < sup.workers and deadline:
        threading.Event().wait(0.05)
        deadline -= 1


def _status(sup) -> dict:
    """The pool's status; its workers as a sorted list without pids and
    slots (which of two warm workers takes a job is a race)."""
    status = sup.status()
    for worker in status["workers"]:
        worker.pop("pid")
        worker.pop("slot")
    status["workers"] = sorted(status["workers"],
                               key=lambda w: json.dumps(w, sort_keys=True))
    status["quarantine"].pop("sidecar")
    return status


def _metric_view(side) -> dict:
    names = ("xla.bucket_compiles", "xla.bucket_reuses",
             "serve.worker.spawns", "serve.worker.restarts",
             "serve.worker.retries", "serve.worker.quarantined",
             "serve.worker.quarantine_refusals")
    view = {name: side.metrics.value(name) for name in names}
    deaths = side.metrics.snapshot().get("serve.worker.deaths") or {}
    view["deaths"] = {label: entry["count"] for label, entry in deaths.items()
                      if isinstance(entry, dict) and "count" in entry}
    return view


def _payload(payload) -> dict:
    payload = dict(payload)
    payload.pop("pid", None)
    return payload


def _outcome(call):
    try:
        return ("ok", _payload(call()))
    except Exception as error:  # noqa: BLE001 — the type is the outcome
        return ("raised", type(error).__name__)


# -- the supervisor cases, each on both packages ----------------------------------

def case_runs_job_and_folds_metrics(side, sup):
    return [_outcome(lambda: sup.run_job({"code": "0x6001"}, cid="cid-1"))]


def case_injected_segv_retries_once(side, sup):
    first_pid = sup.status()["workers"][0]["pid"]
    payload = sup.run_job({"code": "0xdead01"}, cid="cid-2")
    return [payload["pid"] != first_pid, _payload(payload)]


def case_double_death_quarantines(side, sup):
    out = [_outcome(lambda: sup.run_job({"code": "0xdead02"}, cid="c3")),
           _outcome(lambda: sup.run_job({"code": "0xdead02"}, cid="c4"))]
    doc = side.quarantine.load_quarantine(sup.quarantine.path)
    out.append(doc[side.quarantine.contract_key("0xdead02")])
    out.append(_outcome(lambda: sup.run_job({"code": "0x6002"})))
    return out


def case_oom_and_hang(side, sup):
    return [_outcome(lambda: sup.run_job({"code": "0xdead03"}))]


def case_slow_worker_lives(side, sup):
    return [_outcome(lambda: sup.run_job({"code": "0x6003", "fake": "slow",
                                          "beats": 5, "beat_s": 0.25}))]


def case_clean_error_not_retried(side, sup):
    return [_outcome(lambda: sup.run_job({"code": "0x6004",
                                          "fake": "clean_error"})),
            _outcome(lambda: sup.run_job({"code": "0x6005"}))]


def case_plain_exit_crashes_twice(side, sup):
    return [_outcome(lambda: sup.run_job({"code": "0x6006",
                                          "fake": "exit3"}))]


def case_fleet_demux_and_death(side, sup):
    return [_outcome(lambda: {"outcomes": sup.run_fleet(
        [{"code": "0x01"}, {"code": "0x02"}])}),
        sup.quarantine.status()["tracked"]]


SUPERVISOR_CASES = [
    (case_runs_job_and_folds_metrics, {}),
    (case_injected_segv_retries_once, {"inject_fault": "worker_segv:1"}),
    (case_double_death_quarantines,
     {"inject_fault": "worker_segv:1,worker_segv:2"}),
    (case_oom_and_hang, {"inject_fault": "worker_oom:1"}),
    (case_oom_and_hang, {"inject_fault": "worker_hang:1",
                         "heartbeat_ms": 400}),
    (case_slow_worker_lives, {"heartbeat_ms": 600}),
    (case_clean_error_not_retried, {}),
    (case_plain_exit_crashes_twice, {}),
    (case_fleet_demux_and_death, {}),
    (case_fleet_demux_and_death, {"inject_fault": "worker_segv:1"}),
    (case_runs_job_and_folds_metrics, {"workers": 2, "backoff_ms": 5}),
]


@pytest.mark.parametrize("case,overrides", SUPERVISOR_CASES,
                         ids=[f"{case.__name__}-{index}" for index, (case, _)
                              in enumerate(SUPERVISOR_CASES)])
def test_supervisor_case_matches_jax(tmp_path, case, overrides):
    observed = {}
    for name, side in SIDES.items():
        _reset(side)
        directory = tmp_path / name
        directory.mkdir()
        sup = _supervisor(side, directory, **overrides)
        try:
            sup.start()
            _settle(sup)
            result = case(side, sup)
            _settle(sup)
            observed[name] = json.loads(json.dumps(
                (result, _metric_view(side), _status(sup))))
        finally:
            sup.stop()
            _reset(side)
    # the one difference by design: a retry without a checkpoint is sent
    # to the JAX package's host ladder, and the port's keeps the
    # request's engine and solver (no `ladder` flag in its job)
    assert '"ladder": true' not in json.dumps(observed["port"])
    unladdered = json.dumps(observed["jax"]).replace('"ladder": true',
                                                     '"ladder": false')
    assert observed["port"] == json.loads(unladdered)


class _RecordingService:
    """The two engine entry points a worker job reaches, recording the
    params each run gets."""

    def __init__(self):
        self.runs = []

    def _run_analysis_local(self, params, checkpoint_path=None,
                            resume_path=None):
        self.runs.append(params)
        return {"issue_count": 0}

    def _run_optimize_local(self, params):
        self.runs.append(params)
        return {"issue_count": 0}


@pytest.mark.parametrize("kind", ["analyze", "optimize"])
def test_retry_keeps_the_requests_engine_and_solver(kind):
    """A job retried after a death with no checkpoint runs with the
    request's own engine and solver in the port's worker, even when it
    carries the JAX supervisor's `ladder` flag; the JAX worker moves it
    to the host engine and the CDCL."""
    from mythril_tpu.serve import worker as jworker
    from mythril_tpu_torch.serve import worker as pworker

    params = {"code": "0x6001", "engine": "tpu", "solver": "jax"}
    job = {"kind": kind, "job_id": 7, "retry": True, "ladder": True,
           "params": params}
    runs = {}
    for name, module in (("jax", jworker), ("port", pworker)):
        service = _RecordingService()
        run = module._run_optimize if kind == "optimize" \
            else module._run_analyze
        run(service, dict(job))
        runs[name] = service.runs
    assert runs["port"] == [params]
    assert runs["jax"] == [{"code": "0x6001", "engine": "host",
                            "solver": "cdcl"}]


# -- the service in worker mode -------------------------------------------------------

def _worker_service(side, tmp_path, monkeypatch, **overrides):
    monkeypatch.setattr(side.supervisor.Supervisor, "_worker_command",
                        lambda self: list(FAKE_WORKER))
    defaults = dict(manifest_path=str(tmp_path / "warmset.json"),
                    warmup=False, max_inflight=2, workers=1)
    defaults.update(overrides)
    return side.service.AnalysisService(**defaults)


def _strip(reply) -> dict:
    reply = dict(reply)
    for key in ("correlation_id", "elapsed_ms", "uptime_s", "pid"):
        reply.pop(key, None)
    if reply.get("workers"):
        for worker in reply["workers"]["workers"]:
            worker.pop("pid")
        reply["workers"]["quarantine"].pop("sidecar")
    for key in ("result_store", "warm"):
        if isinstance(reply.get(key), dict):
            reply[key] = {k: v for k, v in reply[key].items()
                          if k not in ("sidecar", "warmset")}
    reply.pop("queue", None)
    reply.pop("params", None)
    return reply


@pytest.mark.parametrize("inject", [None, "worker_segv:1,worker_segv:2"])
def test_service_in_worker_mode_matches_jax(tmp_path, monkeypatch, inject):
    """Analyze through the pool, then healthz: routed, retried and
    quarantined alike."""
    observed = {}
    for name, side in SIDES.items():
        _reset(side)
        directory = tmp_path / name
        directory.mkdir()
        service = _worker_service(side, directory, monkeypatch,
                                  inject_fault=inject)
        service.startup()
        try:
            replies = [service.handle(side.protocol.parse_request(
                json.dumps({"op": "analyze", "id": f"w{index}",
                            "code": "0x6001600055"})))
                       for index in range(2)]
            replies.append(service.handle(side.protocol.parse_request(
                '{"op": "healthz", "id": "h"}')))
            observed[name] = [_strip(reply) for reply in replies]
        finally:
            service.shutdown()
            _reset(side)
    assert observed["port"] == observed["jax"]
    if inject:
        assert observed["port"][1]["error"]["code"] == "quarantined"


def test_legacy_service_reports_no_pool():
    service = pservice.AnalysisService(manifest_path=None, warmup=False,
                                       max_inflight=2)
    healthz = service.handle(pprotocol.parse_request(
        '{"op": "healthz", "id": "h"}'))
    assert healthz["workers"] is None


# -- the flock-guarded reclaim of a stale socket --------------------------------------

@pytest.mark.parametrize("side_name", ["jax", "port"])
def test_concurrent_starts_reclaim_stale_socket_exactly_once(tmp_path,
                                                             side_name):
    side = SIDES[side_name]
    path = str(tmp_path / "serve.sock")
    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale.bind(path)
    stale.close()  # bound but never listening: a crashed daemon's husk

    services = [side.service.AnalysisService(manifest_path=None,
                                             warmup=False, max_inflight=2)
                for _ in range(2)]
    for service in services:
        service._run_analysis = lambda params: {
            "issue_count": 0, "incomplete": False, "coverage": {},
            "report": {"issues": []}}
    readies = [threading.Event(), threading.Event()]
    outcomes = [None, None]
    barrier = threading.Barrier(2)

    def run(index):
        try:
            barrier.wait()
            side.daemon.serve_socket(services[index], socket_path=path,
                                     ready_event=readies[index])
            outcomes[index] = "served"
        except RuntimeError:
            outcomes[index] = "refused"

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for thread in threads:
        thread.start()
    winner = None
    for _ in range(100):
        for index, ready in enumerate(readies):
            if ready.wait(0.1):
                winner = index
                break
        if winner is not None:
            break
    assert winner is not None, f"no daemon came up: {outcomes}"
    reply = side.client.request({"op": "ping"}, socket_path=path, timeout=10)
    assert reply["ok"]
    side.client.request({"op": "shutdown"}, socket_path=path, timeout=10)
    for thread in threads:
        thread.join(timeout=10)
    assert sorted(str(o) for o in outcomes) == ["refused", "served"]
    _reset(side)


# -- deadlines and the death taxonomy -------------------------------------------------

@pytest.mark.parametrize("deadline_ms,max_ms", [
    (None, None), (1500, None), (0.5, None), (10 ** 9, None), (None, 5000),
    (9000, 5000), (None, 0), (2000, 0)])
def test_execution_timeout_matches_jax(monkeypatch, deadline_ms, max_ms):
    if max_ms is None:
        port = pservice.execution_timeout_s(deadline_ms)
    else:
        monkeypatch.setenv("MYTHRIL_TPU_SERVE_MAX_DEADLINE_MS", str(max_ms))
        port = pservice.execution_timeout_s(deadline_ms, max_ms)
    assert port == jservice.execution_timeout_s(deadline_ms)


@pytest.mark.parametrize("returncode", [
    None, 0, 1, 3, -signal.SIGSEGV, -signal.SIGBUS, -signal.SIGABRT,
    -signal.SIGKILL, -signal.SIGTERM, 137])
def test_exit_classification_matches_jax(returncode):
    assert presilience.classify_exit_status(returncode) == \
        jresilience.classify_exit_status(returncode)
