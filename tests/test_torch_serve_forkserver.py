"""The port's worker pool forks its workers from a fork server
(mythril_tpu_torch/serve/forkserver.py), where the JAX package's spawns
fresh interpreters. On the CPU, with real workers on both packages:

- a service in worker mode answers tools/loadgen.py's corpus contracts
  through its pool with the JAX pool's results, and a worker killed by
  SIGSEGV (`inject_fault="worker_segv:1"`) is classified, restarted and
  its request retried as the JAX pool does it;
- the port's workers are children of the fork server, which ends with
  the pool;
- a forked worker's exit status reads as `subprocess` reports it;
- `AnalysisService.close` ends the fork server of a service that never
  served (a daemon whose card could not be resolved)."""

import json

import pytest

from chip_smoke import EXPECTED_LOAD
from mythril_tpu.observe import export as jexport
from mythril_tpu.observe import metrics as jmetrics
from mythril_tpu.observe import slog as jslog
from mythril_tpu.observe import trace as jtrace
from mythril_tpu.serve import protocol as jprotocol
from mythril_tpu.serve import service as jservice
from mythril_tpu_torch.observe import export as pexport
from mythril_tpu_torch.observe import metrics as pmetrics
from mythril_tpu_torch.observe import slog as pslog
from mythril_tpu_torch.observe import trace as ptrace
from mythril_tpu_torch.serve import forkserver
from mythril_tpu_torch.serve import protocol as pprotocol
from mythril_tpu_torch.serve import service as pservice
from tools import torch_loadgen

SIDES = {"jax": (jservice, jprotocol, (jmetrics, jtrace, jslog, jexport)),
         "port": (pservice, pprotocol, (pmetrics, ptrace, pslog, pexport))}


def _reset(observe) -> None:
    metrics, trace, slog, export = observe
    metrics.reset()
    trace.reset()
    slog.reset()
    export.reset_ring()


def _parent_pid(pid: int) -> int:
    with open(f"/proc/{pid}/stat") as handle:
        return int(handle.read().rsplit(")", 1)[1].split()[1])


def _pool_run(name, directory, inject):
    """Every corpus contract through a one-worker pool, then the pool's
    status: (results, deaths by class, the status's pool counts)."""
    service_module, protocol, observe = SIDES[name]
    _reset(observe)
    service = service_module.AnalysisService(
        manifest_path=str(directory / "warmset.json"), warmup=False,
        workers=1, max_inflight=1, inject_fault=inject)
    service.startup()
    try:
        results = [torch_loadgen.reply_result(service.handle(
            protocol.parse_request(json.dumps(
                {"op": "analyze", "id": code, "code": code}))))
            for code in EXPECTED_LOAD]
        status = service.handle(protocol.parse_request(
            '{"op": "status", "id": "s"}'))["workers"]
        if name == "port":
            forks = service._supervisor._forks
            assert {_parent_pid(worker["pid"])
                    for worker in status["workers"]} == {forks.process.pid}
        deaths = observe[0].snapshot().get("serve.worker.deaths")
    finally:
        service.shutdown(drain_ms=0)
        _reset(observe)
    if name == "port":
        assert forks.process.poll() is not None
    return results, deaths, {key: status[key] for key in (
        "pool", "live", "restarts", "deaths")}


@pytest.mark.parametrize("inject", [None, "worker_segv:1"])
def test_forked_pool_answers_as_the_jax_pool(tmp_path, inject):
    observed = {}
    for name in SIDES:
        directory = tmp_path / name
        directory.mkdir()
        observed[name] = _pool_run(name, directory, inject)
    assert observed["port"] == observed["jax"]
    results, deaths, pool = observed["port"]
    assert results == [expected["result"]
                       for expected in EXPECTED_LOAD.values()]
    assert pool["restarts"] == (1 if inject else 0)


def test_forked_worker_exit_status_reads_as_subprocess():
    """A worker killed with SIGKILL reports -9, as a `Popen` would."""
    server = forkserver.ForkServer()
    try:
        worker = server.spawn(["--no-warmup"])
        assert json.loads(worker.stdout.readline())["event"] == "ready"
        assert worker.poll() is None
        assert _parent_pid(worker.pid) == server.process.pid
        worker.kill()
        assert worker.wait(timeout=30) == -9
    finally:
        server.close()
    assert server.process.returncode == 0


def test_close_ends_the_fork_server_of_an_unstarted_service(tmp_path):
    service = pservice.AnalysisService(
        manifest_path=str(tmp_path / "warmset.json"), workers=1)
    process = service._supervisor._forks.process
    service.close()
    assert process.poll() is not None
    assert service._supervisor._forks is None
