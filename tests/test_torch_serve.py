"""The port's serving tier against the JAX package's, piece by piece, on
the CPU: the protocol's parse results and encoded lines, the admission
queue on a stubbed clock, the files each package writes (manifest, summary
store, verdict sidecar, result store, quarantine sidecar) read by the
other, the warm set's K11 shape accounting, the serve defaults against the
JAX knob registry, and the kernel build's lock."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from mythril_tpu.observe import metrics as jmetrics
from mythril_tpu.parallel import jax_solver
from mythril_tpu.serve import admission as jadmission
from mythril_tpu.serve import protocol as jprotocol
from mythril_tpu.serve import quarantine as jquarantine
from mythril_tpu.serve import result_store as jresult_store
from mythril_tpu.serve import warmset as jwarmset
from mythril_tpu.support.tpu_config import REGISTRY
from mythril_tpu_torch.observe import metrics as pmetrics
from mythril_tpu_torch.parallel import device_solver
from mythril_tpu_torch.serve import admission as padmission
from mythril_tpu_torch.serve import autoscale as pautoscale
from mythril_tpu_torch.serve import protocol as pprotocol
from mythril_tpu_torch.serve import quarantine as pquarantine
from mythril_tpu_torch.serve import result_store as presult_store
from mythril_tpu_torch.serve import service as pservice
from mythril_tpu_torch.serve import supervisor as psupervisor
from mythril_tpu_torch.serve import warmset as pwarmset

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture
def one_torch_thread():
    """One torch thread for the case, the count before it given back
    after, so that no later case in the process runs at one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_registries():
    jmetrics.reset()
    pmetrics.reset()
    yield
    jmetrics.reset()
    pmetrics.reset()


# -- protocol -------------------------------------------------------------------------

CODE = "0x6080604052"

#: frames of every shape: valid, malformed, oversized, non-object
FRAMES = [
    '{"op": "ping", "id": 1}',
    '{"op": "status"}',
    '{"op": "analyze", "id": "a", "code": "%s"}' % CODE,
    '{"op": "analyze", "id": "b", "code": "6001", "bin_runtime": true, '
    '"modules": ["TxOrigin"], "transaction_count": 3, "strategy": "dfs", '
    '"solver": "jax", "engine": "tpu", "deadline_ms": 1500.5, '
    '"max_depth": 64, "priority": "bulk"}',
    '{"op": "optimize", "id": 7, "code": "0x600160015b"}',
    '{"op": "healthz", "id": "h"}',
    '{"op": "metrics", "id": "m"}',
    '{"op": "shutdown", "id": "s"}',
    "{not json",
    "[1, 2, 3]",
    '"just a string"',
    '{"op": "explode", "id": "x"}',
    '{"id": "n"}',
    '{"op": "ping", "id": 1.5}',
    '{"op": "analyze", "id": "c"}',
    '{"op": "analyze", "id": "d", "code": "abc"}',
    '{"op": "analyze", "id": "e", "code": "zz"}',
    '{"op": "analyze", "id": "f", "code": "60", "modules": "TxOrigin"}',
    '{"op": "analyze", "id": "g", "code": "60", "transaction_count": 0}',
    '{"op": "analyze", "id": "h", "code": "60", "transaction_count": true}',
    '{"op": "analyze", "id": "i", "code": "60", "strategy": "magic"}',
    '{"op": "analyze", "id": "j", "code": "60", "solver": "z3"}',
    '{"op": "analyze", "id": "k", "code": "60", "engine": "gpu"}',
    '{"op": "analyze", "id": "l", "code": "60", "deadline_ms": 0}',
    '{"op": "analyze", "id": "m", "code": "60", "deadline_ms": 1e12}',
    '{"op": "analyze", "id": "n", "code": "60", "max_depth": 5000}',
    '{"op": "analyze", "id": "o", "code": "60", "priority": "urgent"}',
]


def _parse(protocol, frame):
    try:
        request = protocol.parse_request(frame)
    except protocol.ProtocolError as error:
        return ("error", error.code, error.message, error.request_id)
    request_id = request.id
    if isinstance(request_id, str) and request_id.startswith("req-"):
        request_id = "req-N"  # each package numbers its own
    return ("request", request.op, request_id, request.params)


@pytest.mark.parametrize("frame", FRAMES + [f.encode() for f in FRAMES[:4]]
                         + [b"\xff\xfe"])
def test_parse_matches_jax(frame):
    assert _parse(pprotocol, frame) == _parse(jprotocol, frame)


def test_oversized_and_split_frames_match_jax(monkeypatch):
    """The line bound and the stream reassembly, at a small bound."""
    import io

    for protocol in (jprotocol, pprotocol):
        monkeypatch.setattr(protocol, "MAX_LINE_BYTES", 64)
    stream = (b'{"op": "ping", "id": 1}\n{"op": "st' + b'atus"}\n'
              + b"x" * 200 + b'\n\n{"op": "ping"}')

    def frames(protocol):
        class Chunked(io.BytesIO):
            def read1(self, n=-1):  # deliver 7 bytes a read
                return self.read(7)

        return [_parse(protocol, frame) if isinstance(frame, bytes) else frame
                for frame in protocol.read_lines(Chunked(stream))]

    assert frames(pprotocol) == frames(jprotocol)
    assert _parse(pprotocol, "y" * 100) == _parse(jprotocol, "y" * 100)
    assert frames(pprotocol)[2][1] == "line_too_long"


@pytest.mark.parametrize("reply", [
    {"id": 1, "ok": True, "pong": True, "uptime_s": 1.5},
    {"id": "e", "ok": False, "error": {"code": "busy", "message": "a\nb"}},
    {"id": None, "z": [1, {"b": 2, "a": "ü"}], "a": 0.1},
])
def test_encode_is_byte_equal(reply):
    assert pprotocol.encode(reply).encode() == jprotocol.encode(reply).encode()
    assert pprotocol.ok_reply(3, x=1) == jprotocol.ok_reply(3, x=1)
    assert pprotocol.error_reply(3, "c", "m") == jprotocol.error_reply(
        3, "c", "m")
    assert pprotocol.OPS == jprotocol.OPS
    assert pprotocol.PRIORITIES == jprotocol.PRIORITIES


# -- admission on a stubbed clock -----------------------------------------------------

#: an arrival sequence: (priority, deadline_ms) per request, with the p95
#: service time the registry holds before it
ARRIVALS = [("interactive", None), ("bulk", None), ("bulk", 500),
            ("interactive", 20), ("bulk", None), ("interactive", None),
            ("bulk", None), ("interactive", 100000)]


def _wait(predicate, timeout_s: float = 10.0) -> None:
    deadline = time.perf_counter() + timeout_s
    while not predicate():
        assert time.perf_counter() < deadline, "condition never held"
        time.sleep(0.002)


def _admission_run(admission, metrics, clock):
    """Occupy the one slot, queue ARRIVALS on threads (in order), then
    release the slot until every waiter is granted or shed; returns the
    grant order, each outcome, the status and the metric values."""
    clock["t"] = 0.0
    for value in (400.0, 500.0, 600.0):
        metrics.observe("serve.request_ms", value)
    queue = admission.AdmissionQueue(1, capacity=3, retry_after_ms=250)
    assert queue.try_acquire()
    outcomes, granted, threads = {}, [], []
    lock = threading.Lock()

    def arrive(index, priority, deadline):
        try:
            queue.acquire(priority, deadline)
        except admission.Overloaded as shed:
            outcomes[index] = ("shed", shed.reason, shed.retry_after_ms)
            return
        with lock:
            granted.append(index)
        outcomes[index] = ("granted",)

    def settled():
        return sum(queue.depths().values()) \
            + sum(1 for o in list(outcomes.values()) if o[0] == "shed")

    for index, (priority, deadline) in enumerate(ARRIVALS):
        thread = threading.Thread(target=arrive,
                                  args=(index, priority, deadline))
        thread.start()
        threads.append(thread)
        _wait(lambda: settled() == index + 1)
    status = queue.status()
    while len(outcomes) < len(ARRIVALS):
        before = len(granted)
        queue.release()
        _wait(lambda: len(granted) > before)
    for thread in threads:
        thread.join(10)
    names = ("serve.shed.overload", "serve.shed.deadline", "serve.queue.depth")
    return (granted, outcomes, status,
            {name: metrics.value(name) for name in names},
            sorted(metrics.labels("serve.shed.by_class")))


def test_admission_matches_jax(monkeypatch):
    """The same arrivals give the same grants, sheds, retry hints, triage
    refusals and metric values; the clock is stubbed (monotonic stands
    still) so the hints do not depend on the host's timing."""
    from types import SimpleNamespace

    clock = {"t": 0.0}
    for module in (jadmission, padmission):
        monkeypatch.setattr(module, "time",
                            SimpleNamespace(monotonic=lambda: clock["t"]))
    jax_run = _admission_run(jadmission, jmetrics, clock)
    port_run = _admission_run(padmission, pmetrics, clock)
    assert port_run == jax_run
    assert any(o[0] == "shed" for o in port_run[1].values())


def test_autoscaler_matches_jax():
    class Pool:
        def __init__(self):
            self.workers, self.busy, self.live, self.targets = 1, 1, 1, []

        def occupancy(self):
            return {"busy": self.busy, "live": self.live}

        def scale_to(self, target):
            self.targets.append(target)
            return target

    class Queue:
        def __init__(self, depth):
            self.depth = depth

        def depths(self):
            return {"interactive": self.depth, "bulk": 0}

    from mythril_tpu.serve.autoscale import Autoscaler as JAutoscaler

    runs = []
    for scaler_class in (JAutoscaler, pautoscale.Autoscaler):
        pool, queue = Pool(), Queue(2)
        scaler = scaler_class(pool, queue, minimum=1, maximum=3,
                              interval_ms=500, up_after=2, down_after=8)
        for depth, busy in [(2, 1)] * 5 + [(0, 0)] * 20:
            queue.depth, pool.busy = depth, busy
            scaler.tick()
        status = scaler.status()
        status["last_event"].pop("at")
        runs.append((pool.targets, status))
    assert runs[1] == runs[0]


# -- the files cross over -------------------------------------------------------------

def _write_all(side, directory):
    """Every store a daemon writes, by one package, into `directory`."""
    warmset, result_store, quarantine = side
    manifest = os.path.join(directory, "warmset.json")
    warmset.save_manifest(manifest, [("batch", 256, 5, 1, 1024, 4, 32),
                                     ("single", 1, 256, 5, 1, 1024, 32)])
    warmset.save_summaries(warmset.summaries_path_for(manifest),
                           {"ab" * 32: {"version": 1, "code_length": 3}})
    warmset.save_verdicts(warmset.verdicts_path_for(manifest),
                          [[2, [[1, -2], [2]], 1, [True, True]],
                           [1, [[1], [-1]], 0, None]])
    results = result_store.results_path_for(manifest)
    store = result_store.ResultStore(path=results, max_entries=8)
    key = result_store.result_key({"code": CODE, "transaction_count": 2,
                                   "max_depth": 128})
    assert store.put(key, {"issue_count": 0, "incomplete": False,
                           "report": {"issues": []}, "cached": True})
    sidecar = quarantine.QuarantineStore(
        quarantine.quarantine_path_for(manifest), threshold=2)
    sidecar.record_crash(quarantine.contract_key(CODE), "worker_segv")
    sidecar.record_crash(quarantine.contract_key(CODE), "worker_oom")
    return manifest, key


def _read_all(side, manifest):
    warmset, result_store, quarantine = side
    return (warmset.load_manifest(manifest),
            warmset.load_summaries(warmset.summaries_path_for(manifest)),
            warmset.load_verdicts(warmset.verdicts_path_for(manifest)),
            result_store.load_results(result_store.results_path_for(manifest)),
            quarantine.load_quarantine(quarantine.quarantine_path_for(manifest)))


JAX_FILES = (jwarmset, jresult_store, jquarantine)
PORT_FILES = (pwarmset, presult_store, pquarantine)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_over(tmp_path, writer):
    """What either package writes, both read with equal content; the
    bytes on disk are equal too, and the keys agree."""
    written = {}
    for name, side in (("jax", JAX_FILES), ("port", PORT_FILES)):
        directory = tmp_path / name
        directory.mkdir()
        written[name] = _write_all(side, str(directory))
    manifest, key = written[writer]
    assert _read_all(PORT_FILES, manifest) == _read_all(JAX_FILES, manifest)
    assert written["jax"][1] == written["port"][1]
    base = {name: os.path.dirname(written[name][0]) for name in written}
    for filename in sorted(os.listdir(base["jax"])):
        if filename.endswith(".json"):
            with open(os.path.join(base["jax"], filename), "rb") as left, \
                    open(os.path.join(base["port"], filename), "rb") as right:
                assert left.read() == right.read(), filename
    other = "port" if writer == "jax" else "jax"
    reader = presult_store if other == "port" else jresult_store
    store = reader.ResultStore(path=reader.results_path_for(manifest))
    assert store.get(key)["issue_count"] == 0


@pytest.mark.parametrize("content", [
    "{not json", json.dumps({"version": 99}), json.dumps([1, 2]),
    json.dumps({"version": 1, "shapes": ["x", [1], ["batch", "y"]],
                "summaries": {"k": 1}, "verdicts": [[1, 2]],
                "results": {"k": {"payload": 3}},
                "contracts": {"k": "bad"}})])
def test_garbage_is_tolerated_alike(tmp_path, content):
    manifest = str(tmp_path / "warmset.json")
    for path in (manifest, jwarmset.summaries_path_for(manifest),
                 jwarmset.verdicts_path_for(manifest),
                 jresult_store.results_path_for(manifest),
                 jquarantine.quarantine_path_for(manifest)):
        with open(path, "w") as handle:
            handle.write(content)
    assert _read_all(PORT_FILES, manifest) == _read_all(JAX_FILES, manifest)


def test_bounded_stores_evict_alike(tmp_path, monkeypatch):
    """The verdict sidecar's and the result store's bounds, at the same
    size, keep the same entries."""
    runs = []
    for name, (warmset, result_store, _) in (("jax", JAX_FILES),
                                             ("port", PORT_FILES)):
        directory = tmp_path / name
        directory.mkdir()
        path = str(directory / "warmset.verdicts.json")
        entries = [[1, [[index]], 1, [True]] for index in range(1, 6)]
        if name == "jax":
            monkeypatch.setenv("MYTHRIL_TPU_VERDICT_SIDECAR_MAX", "3")
            warmset.save_verdicts(path, entries)
            monkeypatch.delenv("MYTHRIL_TPU_VERDICT_SIDECAR_MAX")
        else:
            warmset.save_verdicts(path, entries, max_entries=3)
        results = str(directory / "warmset.results.json")
        result_store.save_results(
            results, {f"k{i}": {"seq": i, "payload": {"i": i}}
                      for i in range(5)}, 2)
        runs.append((warmset.load_verdicts(path),
                     result_store.load_results(results)))
    assert runs[1] == runs[0]


# -- the warm set ---------------------------------------------------------------------

@pytest.mark.parametrize("key", [
    "bogus", ("bogus", 1, 2, 3), ("single", 1, 256, 5, 0, 16, 8),
    ("single", 1, 256, 5, 1 << 20, 16, 8), ("batch", 256, 5, 1, 16, 1 << 20, 8),
    ("single", 1, 256, 5, 1, 1 << 23, 8), ("single", 1, 0, 5, 1, 16, 8),
    ("single", 1, 256, 31, 1, 16, 8), ("batch", 256, 5, 1, 16, 0, 8),
    ("single", 1, 256, 5, 1, 16), ("single", 1, "x", 5, 1, 16, 8),
    ("single", -1, 256, 5, 1, 16, 8), None, 7])
def test_warm_shape_key_rejects_what_jax_rejects(key):
    assert jax_solver.warm_shape_key(key) is False
    assert device_solver.warm_shape_key(key, device="cpu") is False


def test_multi_device_key_is_skipped_not_raised():
    """A key for two devices is refused on one card, with no error."""
    key = ("single", 2, 4, 1, 2, 1024, 2)
    assert device_solver.warm_shape_key(key, device="cpu") is False
    assert key not in device_solver.observed_shape_keys()


#: small CNFs, solved one by one and as a batch on both lanes
QUERIES = [([[1, 2], [-1, 2], [-2, 3]], 3), ([[1], [-1]], 1),
           ([[1, -2, 3], [2], [-3, -1]], 3), ([[4, 5], [-4], [-5, 1]], 5)]


def test_observed_shape_keys_match_jax(monkeypatch, one_torch_thread):
    """The same queries on the port's CPU lane and on JAX's record the same
    shape keys, and count compiles and reuses alike."""
    monkeypatch.setattr(device_solver, "_SHAPES_RUN", set())
    monkeypatch.setattr(jax_solver, "_SHAPES_RUN", set())
    monkeypatch.setattr(jax_solver, "_AOT_EXECUTABLES", {})
    monkeypatch.setattr(
        "mythril_tpu.parallel.exec_cache.enabled", lambda: False)
    for clauses, n_vars in QUERIES[:2]:
        assert device_solver.solve_cnf_device(
            clauses, n_vars, n_probes=4, chunk=8, device="cpu") == \
            jax_solver.solve_cnf_device(clauses, n_vars, n_probes=4, chunk=8)
    assert device_solver.solve_cnf_device_batch(
        QUERIES, n_probes=4, chunk=8, device="cpu") == \
        jax_solver.solve_cnf_device_batch(QUERIES, n_probes=4, chunk=8)
    assert device_solver.observed_shape_keys() == \
        jax_solver.observed_shape_keys()
    assert [pmetrics.value(name) for name in
            ("xla.bucket_compiles", "xla.bucket_reuses")] == \
        [jmetrics.value(name) for name in
         ("xla.bucket_compiles", "xla.bucket_reuses")]


def test_warmup_then_solve_reuses_bucket(tmp_path, monkeypatch,
                                         one_torch_thread):
    """The port's form of the JAX test of the same name: a manifest-warmed
    bucket makes the first real solve of that shape a reuse."""
    from mythril_tpu_torch.smt.solver import dispatch

    monkeypatch.setattr(device_solver, "_SHAPES_RUN", set())
    path = str(tmp_path / "warmset.json")
    device_solver.solve_cnf_device_batch([([[1]], 1)], n_probes=2, chunk=4,
                                         device="cpu")
    observed = device_solver.observed_shape_keys()
    assert observed == [("batch", 4, 1, 1, 1024, 1, 2)]
    pwarmset.save_manifest(path, observed)

    monkeypatch.setattr(device_solver, "_SHAPES_RUN", set())
    pmetrics.reset()
    dispatch.configure(device="cpu")
    try:
        warm = pwarmset.WarmSet(path)
        assert warm.warmup() == 1
    finally:
        dispatch.reset_settings()
    assert pmetrics.value("serve.warmed_buckets") == 1
    assert pmetrics.value("xla.bucket_compiles") == 1  # paid by warmup
    device_solver.solve_cnf_device_batch([([[1]], 1)], n_probes=2, chunk=4,
                                         device="cpu")
    assert pmetrics.value("xla.bucket_compiles") == 1  # no new first run
    assert pmetrics.value("xla.bucket_reuses") == 1
    assert warm.status()["observed_buckets"] == 1


def test_host_daemon_without_card_leaves_buckets_cold(tmp_path, monkeypatch):
    """No card: a host daemon's warmup keeps the manifest's buckets cold;
    one that asked for the card raises."""
    from mythril_tpu_torch.exceptions import DeviceUnavailable
    from mythril_tpu_torch.smt.solver import dispatch

    monkeypatch.setattr(device_solver, "_SHAPES_RUN", set())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "warmset.json")
    pwarmset.save_manifest(path, [("single", 1, 4, 1, 1, 1024, 2)])
    dispatch.reset_settings()
    warm = pwarmset.WarmSet(path)
    assert warm.warmup() == 0 and len(warm.failed) == 1
    with pytest.raises(DeviceUnavailable):
        pwarmset.WarmSet(path, device_required=True).warmup()


# -- defaults against the JAX knob registry -------------------------------------------

#: every serve default of the port and the JAX knob it stands for
DEFAULTS = [
    (padmission.QUEUE_MAX, "MYTHRIL_TPU_SERVE_QUEUE_MAX"),
    (padmission.RETRY_AFTER_MS, "MYTHRIL_TPU_SERVE_RETRY_AFTER_MS"),
    (pservice.MAX_INFLIGHT, "MYTHRIL_TPU_SERVE_MAX_INFLIGHT"),
    (pservice.DRAIN_MS, "MYTHRIL_TPU_SERVE_DRAIN_MS"),
    (pservice.MAX_DEADLINE_MS, "MYTHRIL_TPU_SERVE_MAX_DEADLINE_MS"),
    (psupervisor.MAX_DEADLINE_MS, "MYTHRIL_TPU_SERVE_MAX_DEADLINE_MS"),
    (pservice.FLEET_WINDOW_MS, "MYTHRIL_TPU_FLEET_WINDOW_MS"),
    (pservice.FLEET_MAX_BATCH, "MYTHRIL_TPU_FLEET_MAX_BATCH"),
    (presult_store.RESULT_STORE_MAX, "MYTHRIL_TPU_RESULT_STORE_MAX"),
    (pwarmset.VERDICT_SIDECAR_MAX, "MYTHRIL_TPU_VERDICT_SIDECAR_MAX"),
    (pquarantine.QUARANTINE_AFTER, "MYTHRIL_TPU_SERVE_QUARANTINE_AFTER"),
    (psupervisor.HEARTBEAT_MS, "MYTHRIL_TPU_SERVE_WORKER_HEARTBEAT_MS"),
    (psupervisor.BACKOFF_MS, "MYTHRIL_TPU_SERVE_WORKER_BACKOFF_MS"),
    (pautoscale.INTERVAL_MS, "MYTHRIL_TPU_SERVE_AUTOSCALE_INTERVAL_MS"),
    (pautoscale.UP_AFTER, "MYTHRIL_TPU_SERVE_AUTOSCALE_UP_AFTER"),
    (pautoscale.DOWN_AFTER, "MYTHRIL_TPU_SERVE_AUTOSCALE_DOWN_AFTER"),
]


def _keyword_defaults():
    """(port keyword default, JAX knob) of the constructors' own flags."""
    import inspect

    service = inspect.signature(pservice.AnalysisService).parameters
    supervisor = inspect.signature(psupervisor.Supervisor).parameters
    scaler = inspect.signature(pautoscale.Autoscaler).parameters
    store = inspect.signature(pwarmset.WarmSet).parameters
    return [
        (service["warmup"].default, "MYTHRIL_TPU_SERVE_WARMUP"),
        (service["fleet"].default, "MYTHRIL_TPU_FLEET_SERVE"),
        (service["workers"].default, "MYTHRIL_TPU_SERVE_WORKERS"),
        (service["inject_fault"].default, "MYTHRIL_TPU_INJECT_FAULT"),
        (service["result_store"].default, "MYTHRIL_TPU_RESULT_STORE"),
        (service["verdict_sidecar"].default, "MYTHRIL_TPU_VERDICT_SIDECAR"),
        (store["verdict_sidecar"].default, "MYTHRIL_TPU_VERDICT_SIDECAR"),
        (service["trace_out"].default, "MYTHRIL_TPU_TRACE"),
        (service["workers_min"].default, "MYTHRIL_TPU_SERVE_WORKERS_MIN"),
        (service["workers_max"].default, "MYTHRIL_TPU_SERVE_WORKERS_MAX"),
        (scaler["minimum"].default, "MYTHRIL_TPU_SERVE_WORKERS_MIN"),
        (scaler["maximum"].default, "MYTHRIL_TPU_SERVE_WORKERS_MAX"),
        (service["max_inflight"].default, "MYTHRIL_TPU_SERVE_MAX_INFLIGHT"),
        (service["queue_max"].default, "MYTHRIL_TPU_SERVE_QUEUE_MAX"),
        (service["drain_ms"].default, "MYTHRIL_TPU_SERVE_DRAIN_MS"),
        (supervisor["heartbeat_ms"].default,
         "MYTHRIL_TPU_SERVE_WORKER_HEARTBEAT_MS"),
        (service["heartbeat_ms"].default,
         "MYTHRIL_TPU_SERVE_WORKER_HEARTBEAT_MS"),
        (service["autoscale_interval_ms"].default,
         "MYTHRIL_TPU_SERVE_AUTOSCALE_INTERVAL_MS"),
        (supervisor["quarantine_after"].default,
         "MYTHRIL_TPU_SERVE_QUARANTINE_AFTER"),
    ]


ALL_DEFAULTS = DEFAULTS + _keyword_defaults()


@pytest.mark.parametrize("default,knob", ALL_DEFAULTS,
                         ids=[f"{knob}-{index}" for index, (_, knob)
                              in enumerate(ALL_DEFAULTS)])
def test_serve_defaults_are_the_jax_knobs(default, knob):
    assert default == REGISTRY[knob].default, knob


def test_worker_argv_carries_what_jax_puts_in_the_environment(tmp_path):
    from mythril_tpu_torch.observe import slog

    sink = str(tmp_path / "s.slog")
    slog.enable(sink)
    try:
        sup = psupervisor.Supervisor(
            1, manifest_path=str(tmp_path / "m.json"), engine="tpu",
            solver="jax", warmup=False, max_deadline_ms=1234,
            verdict_sidecar=False, verdict_sidecar_max=9)
        argv = sup._worker_command()
        sup.stop()
    finally:
        slog.reset()
    assert argv[1:3] == ["-m", "mythril_tpu_torch.serve.worker"]
    assert argv[3:] == [
        "--solver", "jax", "--engine", "tpu", "--strategy", "bfs",
        "--heartbeat-ms", "30000", "--max-deadline-ms", "1234",
        "--verdict-sidecar-max", "9", "--manifest", str(tmp_path / "m.json"),
        "--no-warmup", "--no-verdict-sidecar", "--slog", sink]
    assert not hasattr(psupervisor.Supervisor, "_worker_env")


def test_default_paths_are_the_ports_own(monkeypatch, tmp_path):
    from mythril_tpu.serve import daemon as jdaemon
    from mythril_tpu_torch.serve import daemon as pdaemon

    monkeypatch.setenv("HOME", str(tmp_path))
    assert pdaemon.default_socket_path() == str(
        tmp_path / ".mythril_tpu_torch" / "serve.sock")
    assert pwarmset.default_manifest_path() == str(
        tmp_path / ".mythril_tpu_torch" / "warmset.json")
    assert pdaemon.default_socket_path() != jdaemon.default_socket_path()


# -- the kernel build's lock ----------------------------------------------------------

_BUILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    from mythril_tpu_torch.kernels import build
    from mythril_tpu_torch.observe import metrics
    build.BUILD_DIR = {build_dir!r}
    build.nvcc_path = lambda: {nvcc!r}
    build.build_all()
    print(int(metrics.value("cache.exec.misses")))
""")

_NVCC = textwrap.dedent("""\
    #!{python}
    import sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open({calls!r}, "a") as handle:
        handle.write(sys.argv[-1] + "\\n")
    time.sleep(0.2)
    with open(out, "w") as handle:
        handle.write("library")
""")


def test_two_cold_builds_run_nvcc_once_per_source(tmp_path):
    """Two processes that build at once on a cold checkout run the compiler
    once per source (the build lock), and count the misses between them."""
    from mythril_tpu_torch.kernels import build

    calls = str(tmp_path / "calls.txt")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_NVCC.format(python=sys.executable, calls=calls))
    nvcc.chmod(0o755)
    script = _BUILD.format(repo=REPO, build_dir=str(tmp_path / "build"),
                           nvcc=str(nvcc))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    misses = [int(proc.communicate(timeout=120)[0]) for proc in procs]
    assert all(proc.returncode == 0 for proc in procs)
    with open(calls) as handle:
        built = sorted(line.rsplit("/", 1)[-1] for line in handle.read().split())
    assert built == sorted(f"{name}.cu" for name in build.SOURCES)
    assert sorted(misses) == [0, len(build.SOURCES)]
    assert len(os.listdir(tmp_path / "build")) == len(build.SOURCES) + 1
