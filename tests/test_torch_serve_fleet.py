"""The port's serving tier end to end against the JAX package's, on the
CPU: a `--fleet` service that batches two concurrent compatible requests
into one fleet (the port's twins at 16 lanes against the JAX service under
MYTHRIL_TPU_LANES=16), and the two CLIs: a `serve --stdio` session (ping,
analyze, metrics, shutdown) gives equal reply lines but for clocks,
`client` with no daemon exits alike with the same message, and the port's
`serve --engine tpu` or `--solver jax` without a card exits 2 naming the
CUDA device."""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from _torch_engine import JAX, PORT, report_parity, run_on
from chip_smoke import TX_ORIGIN
from test_fleet import ADDFLOW, BRANCHY, MODULES, _creation_hex
from test_torch_serve_service import SERVE, analyze_frame, normalize
from mythril_tpu_torch.parallel import frontier as pf

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N_LANES = 16
#: a join window wide enough for two threads' arrivals on a busy host
FLEET_WINDOW_MS = 500.0


@pytest.fixture
def sixteen_lanes(monkeypatch):
    threads = torch.get_num_threads()
    monkeypatch.setenv("MYTHRIL_TPU_LANES", str(N_LANES))
    pf.configure(lanes=N_LANES, device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pf.reset()


def fleet_case(side, directory):
    """Two compatible requests sent at once to a `--fleet` service of one
    side: both replies (normalized) and reports."""
    service_module, protocol, _ = SERVE[side.name]
    # the join window: the port's argument, the JAX knob (set by the test)
    window = {"fleet_window_ms": FLEET_WINDOW_MS} if side is PORT else {}
    service = service_module.AnalysisService(
        manifest_path=str(directory / "warmset.json"), warmup=False,
        max_inflight=2, fleet=True, workers=0, engine="tpu", **window)
    frames = {name: json.dumps({
        "op": "analyze", "id": name, "code": _creation_hex(contract),
        "transaction_count": 1, "modules": list(MODULES)})
        for name, contract in (("branchy", BRANCHY), ("addflow", ADDFLOW))}
    replies = {}
    barrier = threading.Barrier(len(frames))

    def send(name):
        barrier.wait()
        replies[name] = service.handle(protocol.parse_request(frames[name]))

    threads = [threading.Thread(target=send, args=(name,)) for name in frames]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(600)
    service.shutdown(drain_ms=0)
    return ({name: normalize(reply, str(directory))
             for name, reply in replies.items()},
            {name: reply["report"] for name, reply in replies.items()})


def test_fleet_service_batches_as_the_jax_service(tmp_path, sixteen_lanes,
                                                   monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_FLEET_WINDOW_MS", str(FLEET_WINDOW_MS))
    observed = {}
    for side in (JAX, PORT):
        directory = tmp_path / side.name
        directory.mkdir()
        observed[side.name] = run_on(side, fleet_case, directory)
    (jax_replies, jax_reports), (port_replies, port_reports) = \
        observed["jax"], observed["port"]
    assert port_replies == jax_replies
    for name in port_reports:
        report_parity(port_reports[name], jax_reports[name], same_pool=False)
        assert port_replies[name]["fleet_batched"] == 2
    assert [i["swc-id"] for i in port_reports["branchy"]["issues"]] == ["106"]


# -- the two CLIs -----------------------------------------------------------------

def run_cli(package: str, argv, home, stdin: str = "", timeout: int = 300):
    env = dict(os.environ, HOME=str(home),
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, "-m", package, *argv],
                          input=stdin, capture_output=True, text=True,
                          env=env, cwd=str(home), timeout=timeout)


def test_stdio_sessions_reply_alike(tmp_path):
    frames = ['{"op": "ping", "id": "p"}',
              analyze_frame("a", TX_ORIGIN, "TxOrigin", 1),
              '{"op": "metrics", "id": "m"}',
              '{"op": "shutdown", "id": "s"}']
    sessions = {}
    for package in ("mythril_tpu", "mythril_tpu_torch"):
        home = tmp_path / package
        home.mkdir()
        done = run_cli(package, ["serve", "--stdio", "--manifest",
                                 str(home / "warmset.json")], home,
                       stdin="\n".join(frames) + "\n")
        assert done.returncode == 0, done.stderr[-2000:]
        lines = [json.loads(line) for line in done.stdout.splitlines()]
        sessions[package] = ([normalize(reply, str(home)) for reply in lines],
                             [reply["report"] for reply in lines
                              if "report" in reply])
    jax, port = sessions["mythril_tpu"], sessions["mythril_tpu_torch"]
    assert port[0] == jax[0]
    assert [reply["id"] for reply in port[0]] == ["p", "a", "m", "s"]
    report_parity(port[1][0], jax[1][0], same_pool=False)


def test_client_without_daemon_exits_alike(tmp_path):
    socket_path = str(tmp_path / "none.sock")
    done = {package: run_cli(package, ["client", "ping", "--socket",
                                       socket_path], tmp_path)
            for package in ("mythril_tpu", "mythril_tpu_torch")}
    jax, port = done["mythril_tpu"], done["mythril_tpu_torch"]
    assert port.returncode == jax.returncode == 2
    assert port.stdout == jax.stdout == ""
    assert port.stderr.replace("myth-tpu-torch", "myth-tpu") == jax.stderr


@pytest.mark.parametrize("argv", [["--engine", "tpu"], ["--solver", "jax"]])
def test_serve_on_the_card_without_one_exits_2(tmp_path, argv):
    assert not torch.cuda.is_available()
    done = run_cli("mythril_tpu_torch",
                   ["serve", "--stdio", "--manifest",
                    str(tmp_path / "warmset.json"), *argv], tmp_path,
                   stdin='{"op": "ping"}\n', timeout=120)
    assert done.returncode == 2
    assert "CUDA device" in done.stderr
    assert done.stdout == ""
    assert not os.path.exists(tmp_path / "warmset.results.json")
