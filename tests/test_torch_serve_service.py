"""The port's `AnalysisService` against the JAX package's, on the CPU: the
same request sequence through both packages' `handle` gives equal replies
but for clocks, uptimes and generated ids, and equal reports
(`report_parity`: the witnesses, which depend on the process's CNF, are
replayed on the port's engine).

- A host daemon (`--engine host`, the CDCL): ping, status, analyze of
  chip_smoke's ANALYZE_RUNS, a repeat answered from the result store, a
  protocol error, healthz, metrics and shutdown; the result sidecar each
  side wrote.
- One `"engine": "tpu"` request on the tx.origin contract at 16 lanes (the
  port's twins, `frontier.configure(lanes=16, device="cpu")`, against the
  JAX service under MYTHRIL_TPU_LANES=16), and one `"solver": "jax"`
  request on the CPU lane (the device clause cap at 4096 on both, as
  tests/test_torch_device_lane.py sets it).
- An `optimize` request on tests/test_superopt.py's synthetic code.
- Without a card, a host daemon answers `"engine": "tpu"` and
  `"solver": "jax"` requests with the typed `analysis_failed` reply.

Each case runs from `fresh` counters, solver backend, registries and
tracers on both sides (tests/_torch_engine.py `run_on`), and from empty
sets of run shape keys: each solver's `_SHAPES_RUN` is a process global
that an earlier file on the same worker may have filled, and a status
reply counts it (`warmset.observed_buckets`); and from empty snapshot
rings, the `metrics` reply's tail of another process global, which
another file's requests may have filled (tests/test_torch_serve_fleet.py
records two concurrent requests there, in the order they finished)."""

import json

import pytest
import torch

from _torch_engine import JAX, PORT, report_parity, run_on
from chip_smoke import (ANALYZE_RUNS, EXPECTED_ANALYZE, KILLBILLY,
                        OPTIMIZE_CODES, TX_ORIGIN, deterministic)
from mythril_tpu.observe import export as jexport
from mythril_tpu.parallel import jax_solver
from mythril_tpu.serve import protocol as jprotocol
from mythril_tpu.serve import result_store as jresult_store
from mythril_tpu.serve import service as jservice
from mythril_tpu_torch.frontends.asm import (assemble, creation_wrapper,
                                             dispatcher)
from mythril_tpu_torch.observe import export as pexport
from mythril_tpu_torch.parallel import device_solver
from mythril_tpu_torch.parallel import frontier as pf
from mythril_tpu_torch.serve import protocol as pprotocol
from mythril_tpu_torch.serve import result_store as presult_store
from mythril_tpu_torch.serve import service as pservice
from mythril_tpu_torch.smt.solver import dispatch as pdispatch

SERVE = {"jax": (jservice, jprotocol, jresult_store),
         "port": (pservice, pprotocol, presult_store)}
#: reply fields that read a clock or are minted per run
CLOCKS = frozenset(("uptime_s", "elapsed_ms", "correlation_id", "wall_ms",
                    "ts"))
N_LANES = 16
CLAUSE_CAP = 4096


def creation(contract) -> str:
    return creation_wrapper(assemble(dispatcher(contract))).hex()


def analyze_frame(request_id, contract, modules, transaction_count, **extra):
    doc = {"op": "analyze", "id": request_id, "code": creation(contract),
           "transaction_count": transaction_count, **extra}
    if modules:
        doc["modules"] = modules.split(",")
    return json.dumps(doc)


def normalize(value, directory: str):
    """A reply without its clocks, with the side's directory as <dir>,
    the registry snapshot as chip_smoke's `deterministic` keeps it and the
    report set aside (compared by `report_parity`)."""
    if isinstance(value, dict):
        out = {}
        for key, item in value.items():
            if key in CLOCKS or key == "report":
                continue
            if key == "metrics" and isinstance(item, dict):
                item = deterministic(item)
            if key == "exposition":
                # the serve series, but the time-valued ones only by count
                item = sorted(line for line in item.splitlines()
                              if line.startswith("mythril_tpu_serve_")
                              and ("_ms" not in line or "_ms_count" in line))
            out[key] = normalize(item, directory)
        return out
    if isinstance(value, list):
        return [normalize(item, directory) for item in value]
    if isinstance(value, str):
        return value.replace(directory, "<dir>")
    return value


def drive(side, directory, frames, **settings):
    """`frames` through one side's service: (normalized replies, reports,
    the result sidecar's payloads)."""
    service_module, protocol, result_store = SERVE[side.name]
    manifest = str(directory / "warmset.json")
    service = service_module.AnalysisService(
        manifest_path=manifest, warmup=False, max_inflight=2, fleet=False,
        workers=0, **settings)
    replies, reports = [], []
    for frame in frames:
        try:
            request = protocol.parse_request(frame)
        except protocol.ProtocolError as error:
            request = error
        reply = service.handle(request)
        if "report" in reply:
            reports.append(reply["report"])
        replies.append(normalize(reply, str(directory)))
    service.shutdown(drain_ms=0)
    stored = result_store.load_results(result_store.results_path_for(manifest))
    return replies, reports, sorted(
        json.dumps(normalize(entry["payload"], str(directory)),
                   sort_keys=True) for entry in stored.values())


def both(tmp_path, frames, **settings):
    out = {}
    for side in (JAX, PORT):
        directory = tmp_path / side.name
        directory.mkdir()
        out[side.name] = run_on(side, drive, directory, frames, **settings)
    return out["jax"], out["port"]


@pytest.fixture(autouse=True)
def _no_shapes_run(monkeypatch):
    monkeypatch.setattr(jax_solver, "_SHAPES_RUN", set())
    monkeypatch.setattr(device_solver, "_SHAPES_RUN", set())


@pytest.fixture(autouse=True)
def _empty_rings():
    for export in (jexport, pexport):
        export.reset_ring()
    yield
    for export in (jexport, pexport):
        export.reset_ring()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


HOST_FRAMES = (
    ['{"op": "ping", "id": "p"}', '{"op": "status", "id": "s"}']
    + [analyze_frame(name, *ANALYZE_RUNS[name]) for name in ANALYZE_RUNS]
    + [analyze_frame("repeat", *ANALYZE_RUNS["killbilly"]),
       '{"op": "analyze", "id": "bad", "code": "zz"}', "{not json",
       '{"op": "healthz", "id": "h"}', '{"op": "metrics", "id": "m"}',
       '{"op": "shutdown", "id": "down"}', '{"op": "ping", "id": "late"}'])


def test_host_daemon_replies_are_the_jax_daemons(tmp_path):
    (jax_replies, jax_reports, jax_stored), \
        (port_replies, port_reports, port_stored) = both(tmp_path,
                                                         HOST_FRAMES)
    assert port_replies == jax_replies
    assert port_stored == jax_stored
    assert len(port_reports) == len(jax_reports) == 4
    for port, jax in zip(port_reports, jax_reports):
        report_parity(port, jax, same_pool=False)
    by_id = {reply["id"]: reply for reply in port_replies}
    assert by_id["repeat"]["cached"] is True
    for name in ANALYZE_RUNS:
        issues = [[i["swc-id"], i["title"], i["address"]]
                  for i in port_reports[list(ANALYZE_RUNS).index(name)][
                      "issues"]]
        assert issues == EXPECTED_ANALYZE[name]["issues"]
    assert by_id["bad"]["error"]["code"] == "bad_request"
    assert by_id[None]["error"]["code"] == "bad_json"
    assert by_id["late"]["error"]["code"] == "shutting_down"


@pytest.fixture
def sixteen_lanes(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_LANES", str(N_LANES))
    monkeypatch.setenv("MYTHRIL_TPU_DEVICE_CLAUSE_CAP", str(CLAUSE_CAP))
    pf.configure(lanes=N_LANES, device="cpu")
    pdispatch.configure(device="cpu", clause_cap=CLAUSE_CAP)
    yield
    pf.reset()
    pdispatch.reset_settings()


def test_tpu_and_jax_requests_are_the_jax_daemons(tmp_path, sixteen_lanes):
    """`"engine": "tpu"` at 16 lanes and `"solver": "jax"` on the CPU lane,
    through a host daemon of each package, then an optimize request."""
    frames = [analyze_frame("tpu", TX_ORIGIN, "TxOrigin", 1, engine="tpu"),
              analyze_frame("jax", TX_ORIGIN, "TxOrigin", 1, solver="jax"),
              json.dumps({"op": "optimize", "id": "opt",
                          "code": OPTIMIZE_CODES["synthetic"]}),
              analyze_frame("both", KILLBILLY, "AccidentallyKillable", 1,
                            engine="tpu", solver="jax")]
    (jax_replies, jax_reports, jax_stored), \
        (port_replies, port_reports, port_stored) = both(tmp_path, frames)
    assert port_replies == jax_replies
    assert port_stored == jax_stored
    for port, jax in zip(port_reports, jax_reports):
        report_parity(port, jax, same_pool=False)
    by_id = {reply["id"]: reply for reply in port_replies}
    assert by_id["tpu"]["frontier"]["executed"] > 0
    assert by_id["opt"]["rewrites"]
    assert [[i["swc-id"], i["address"]] for i in port_reports[0]["issues"]] \
        == [["115", 27]]


def test_host_daemon_without_a_card_refuses_device_requests(tmp_path):
    """No card and no CPU device named: the request gets the typed error
    reply naming the CUDA device, never a host run in its place."""
    pf.reset()
    pdispatch.reset_settings()
    assert not torch.cuda.is_available()

    def case(side):
        frames = [analyze_frame("tpu", TX_ORIGIN, "TxOrigin", 1,
                                engine="tpu"),
                  analyze_frame("jax", TX_ORIGIN, "TxOrigin", 1,
                                solver="jax")]
        return drive(side, tmp_path, frames)

    replies, reports, stored = run_on(PORT, case)
    assert reports == [] and stored == []
    for reply in replies:
        assert reply["ok"] is False
        assert reply["error"]["code"] == "analysis_failed"
        assert "DeviceUnavailable" in reply["error"]["message"]
        assert "CUDA device" in reply["error"]["message"]
