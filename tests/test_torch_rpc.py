"""The port's JSON-RPC client (ethereum/rpc.py), its choice of endpoint
(mythril/mythril_config.py) and its on-chain input (`-a`, `--rpc`,
`read-storage`, `disassemble -a`) against the JAX package's, on the CPU,
each case against chip_smoke.py's `ChainStub`, a JSON-RPC chain on
127.0.0.1 that logs every request.

- `from_preset` and the client's URL over a table of inputs;
- every method's request body (method, params, id) and result;
- `RPCError` on a JSON-RPC error and on a closed port, with one message;
- `DynLoader`'s reads and their requests;
- `set_api_rpc`'s fallback order (argument, default, config.ini,
  infura-mainnet), the port's default held to the JAX knob's;
- both CLIs in this process (tests/_torch_engine.py `cli_main`, from
  fresh counters): `read-storage` and `disassemble -a`; `analyze -a --rpc
  --engine host` in text and JSON; `--engine tpu` on the port's twins at
  16 lanes against the JAX frontier at MYTHRIL_TPU_LANES=16 (reports, each
  transaction's `frontier:` line word for word, a storage fault-in); each
  with the chain's request logs equal. `-a` is chip_smoke's
  ONCHAIN_ADDRESS, in mixed case: the fault-ins ask for the lower-case
  address and the stub answers both;
- a chain that fails `eth_getStorageAt`: both CLIs (subprocesses) exit
  with one code, one report and one last stderr line (up to the
  package's name);
- `--engine tpu` without a card: exit 2 naming the CUDA device;
- chip_smoke's EXPECTED_ONCHAIN, EXPECTED_ONCHAIN_RPC and
  EXPECTED_ONCHAIN_OUTPUT recomputed with the JAX CLI at 128 lanes, and
  the onchain_tpu phase's own checks passed by the port on its twins.

No case builds a request to a host other than 127.0.0.1: config.ini is
read from the test's own directory."""

import hashlib
import inspect
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

import chip_smoke
from _torch_engine import JAX, PORT, cli_main, report_parity
from chip_smoke import (EXPECTED_ONCHAIN, EXPECTED_ONCHAIN_OUTPUT,
                        EXPECTED_ONCHAIN_RPC, FRONTIER_LINE, ONCHAIN_ADDRESS,
                        ONCHAIN_COMMANDS, ONCHAIN_RUNS, ChainStub,
                        onchain_argv, onchain_chain)
from mythril_tpu.ethereum import rpc as jrpc
from mythril_tpu.mythril import mythril_config as jconfig
from mythril_tpu.support import loader as jloader
from mythril_tpu.support.tpu_config import REGISTRY
from mythril_tpu_torch.ethereum import rpc as prpc
from mythril_tpu_torch.mythril import mythril_config as pconfig
from mythril_tpu_torch.parallel import frontier as pf
from mythril_tpu_torch.support import loader as ploader

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RPC = {"jax": jrpc, "port": prpc}
LOADER = {"jax": jloader, "port": ploader}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def outcome(call):
    """A call's result, or its exception's type name and message."""
    try:
        return ("ok", call())
    except Exception as error:
        return (type(error).__name__, str(error))


PRESETS = [("ganache", False), ("ganache", True), ("infura-mainnet", False),
           ("infura-sepolia", True), ("127.0.0.1:8545", False),
           ("localhost:7545", True), ("node.example", False),
           ("node.example", True), ("http://node.example:8545", False),
           ("https://node.example", False), ("node.example:port", False)]


@pytest.mark.parametrize("rpc, tls", PRESETS,
                         ids=[f"{rpc}-{tls}" for rpc, tls in PRESETS])
def test_from_preset_builds_the_jax_url(rpc, tls):
    got = {side: outcome(lambda: module.EthJsonRpc.from_preset(rpc, tls).url)
           for side, module in RPC.items()}
    assert got["port"] == got["jax"]


CLIENTS = [("localhost", 8545, False), ("localhost", None, True),
           ("10.0.0.1", 0, False), ("http://host", 8545, False),
           ("https://host/v3/KEY", None, True)]


@pytest.mark.parametrize("host, port, tls", CLIENTS)
def test_client_url_is_the_jax_url(host, port, tls):
    assert prpc.EthJsonRpc(host, port, tls).url == \
        jrpc.EthJsonRpc(host, port, tls).url


#: canned results of the methods the stub does not answer from its state
ANSWERS = {"eth_blockNumber": "0x10", "eth_coinbase": "0x" + "ab" * 20,
           "eth_getTransactionReceipt": {"status": "0x1"},
           "eth_getBlockByNumber": {"number": "0x10"},
           "eth_getBlockByHash": {"hash": "0x" + "01" * 32},
           "eth_getTransactionByHash": {"nonce": "0x2"},
           "eth_getTransactionCount": "0x3", "eth_gasPrice": "0x4a817c800",
           "eth_call": "0x" + "00" * 31 + "01", "eth_estimateGas": "0x5208",
           "eth_sendRawTransaction": "0x" + "cd" * 32, "net_version": "1",
           "web3_clientVersion": "stub/1"}
ADDRESS = int(ONCHAIN_ADDRESS, 16)
#: every method, with an address as text and as an int, a block as text
#: and as an int, and a position as an int and as text
CALLS = [("eth_getCode", (ONCHAIN_ADDRESS,)), ("eth_getCode", (ADDRESS,)),
         ("eth_getStorageAt", (ONCHAIN_ADDRESS, 0)),
         ("eth_getStorageAt", (ADDRESS, "0x1", "0x5")),
         ("eth_getBalance", (ONCHAIN_ADDRESS,)),
         ("eth_getTransactionReceipt", ("0x" + "02" * 32,)),
         ("eth_blockNumber", ()), ("eth_coinbase", ()),
         ("eth_getBlockByNumber", ()), ("eth_getBlockByNumber", (16, False)),
         ("eth_getBlockByHash", ("0x" + "01" * 32,)),
         ("eth_getTransactionByHash", ("0x" + "02" * 32,)),
         ("eth_getTransactionCount", (ADDRESS, "pending")),
         ("eth_gasPrice", ()), ("eth_call", (ADDRESS, "0x12345678")),
         ("eth_estimateGas", ({"to": ONCHAIN_ADDRESS},)),
         ("eth_sendRawTransaction", ("0xf86b",)), ("net_version", ()),
         ("web3_clientVersion", ())]


def test_every_method_sends_the_jax_request():
    """Each method's body (jsonrpc, method, params, id: 1, 2, ... on one
    client) and its result, the JAX client's then the port's on one
    chain."""
    got = {}
    with ChainStub({ONCHAIN_ADDRESS: chip_smoke.ONCHAIN_CODE},
                   storage={(ONCHAIN_ADDRESS, 0): 1},
                   balances={ONCHAIN_ADDRESS: 7}, answers=ANSWERS) as chain:
        for side, module in RPC.items():
            chain.clear()
            client = module.EthJsonRpc.from_preset(chain.rpc)
            results = [getattr(client, method)(*args)
                       for method, args in CALLS]
            got[side] = (results, list(chain.bodies))
    assert got["port"] == got["jax"]
    results, bodies = got["port"]
    assert [body["id"] for body in bodies] == list(range(1, len(CALLS) + 1))
    assert [body["method"] for body in bodies] == [m for m, _ in CALLS]
    assert results[0] == "0x" + chip_smoke.ONCHAIN_CODE and results[4] == 7


def closed_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_rpc_errors_are_the_jax_errors():
    """A JSON-RPC error reply and a refused connection both raise
    RPCError, which is not a ValueError (so `Storage.__getitem__` does not
    swallow it), with the JAX client's message."""
    got = {}
    with ChainStub({}, fail=("eth_getStorageAt",)) as chain:
        for side, module in RPC.items():
            client = module.EthJsonRpc.from_preset(chain.rpc)
            got[side] = [outcome(lambda: client.eth_getStorageAt(
                             ONCHAIN_ADDRESS, 0)),
                         outcome(lambda: client.eth_getTransactionReceipt(
                             "0x00"))]
    port = closed_port()
    for side, module in RPC.items():
        client = module.EthJsonRpc("127.0.0.1", port)
        got[side].append(outcome(lambda: client.eth_getCode(ONCHAIN_ADDRESS)))
    assert got["port"] == got["jax"]
    assert {kind for kind, _ in got["port"]} == {"RPCError"}
    assert "does not serve eth_getStorageAt" in got["port"][0][1]
    assert not issubclass(prpc.RPCError, ValueError)


def test_dynloader_reads_are_the_jax_reads():
    """read_storage, read_balance and dynld (a second read of a slot is
    the loader's cache), and an address with no code, with the JAX
    loader's results and requests."""
    other = "0x" + "22" * 20
    got = {}
    with onchain_chain(1) as chain:
        for side, module in RPC.items():
            chain.clear()
            loader = LOADER[side].DynLoader(
                module.EthJsonRpc.from_preset(chain.rpc))
            code = loader.dynld(ONCHAIN_ADDRESS)
            values = [loader.read_storage(ONCHAIN_ADDRESS.lower(), 0),
                      loader.read_storage(ONCHAIN_ADDRESS.lower(), 0),
                      loader.read_storage(ONCHAIN_ADDRESS, 1),
                      loader.read_balance(ONCHAIN_ADDRESS),
                      [(i.address, i.op_code, i.argument)
                       for i in code.instruction_list],
                      loader.dynld(other)]
            off = LOADER[side].DynLoader(None, active=False)
            got[side] = (values, chain.log,
                         [outcome(lambda: off.read_storage(other, 0)),
                          off.dynld(other)])
    assert got["port"] == got["jax"]
    values, log, _ = got["port"]
    assert values[0] == "0x" + "0" * 63 + "1" and values[3] == 10 ** 18
    assert values[5] is None
    assert [method for method, _ in log].count("eth_getStorageAt") == 2


#: (--rpc argument, default endpoint, config.ini's dynamic_loading)
FALLBACKS = [("127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"),
             (None, "127.0.0.1:2", "127.0.0.1:3"),
             (None, None, "127.0.0.1:3"), (None, None, None),
             (None, "ganache", None), ("infura-sepolia", None, None)]


@pytest.mark.parametrize("rpc, default, ini", FALLBACKS)
def test_set_api_rpc_falls_back_as_the_jax_config(tmp_path, monkeypatch,
                                                  rpc, default, ini):
    """Argument, then the default (the JAX package's MYTHRIL_TPU_RPC, the
    port's `default_rpc`), then config.ini's `dynamic_loading`, then
    infura-mainnet: the same client URL, and no request made."""
    path = tmp_path / "config.ini"
    if ini:
        path.write_text(f"[defaults]\ndynamic_loading = {ini}\n")
    if default:
        monkeypatch.setenv("MYTHRIL_TPU_RPC", default)
    else:
        monkeypatch.delenv("MYTHRIL_TPU_RPC", raising=False)
    jax = jconfig.MythrilConfig(config_path=str(path))
    jax.set_api_rpc(rpc, rpctls=True)
    port = pconfig.MythrilConfig(config_path=str(path),
                                 mythril_dir=str(tmp_path))
    port.set_api_rpc(rpc, rpctls=True, default_rpc=default)
    assert port.eth.url == jax.eth.url
    assert port.eth._id == jax.eth._id == 0


def test_rpc_default_is_the_jax_knobs():
    parameter = inspect.signature(
        pconfig.MythrilConfig.set_api_rpc).parameters["default_rpc"]
    assert parameter.default == REGISTRY["MYTHRIL_TPU_RPC"].default


@pytest.mark.parametrize("name", list(ONCHAIN_COMMANDS))
def test_onchain_commands_print_the_jax_output(name):
    """`read-storage` (positions and a mapping key) and `disassemble -a`:
    the JAX CLI's exit code, output and requests, and EXPECTED_ONCHAIN's
    digest and log (chip_smoke's onchain_tpu phase holds the port to
    those on the card)."""
    got = {}
    with onchain_chain(1) as chain:
        for side in (JAX, PORT):
            chain.clear()
            exit_code, out, _ = cli_main(side, onchain_argv(name, chain.rpc))
            got[side.name] = (exit_code, out, chain.log)
    assert got["port"] == got["jax"]
    exit_code, out, log = got["port"]
    assert exit_code == 0 and out
    assert hashlib.sha256(out.encode()).hexdigest() == \
        EXPECTED_ONCHAIN_OUTPUT[name]
    assert log == EXPECTED_ONCHAIN_RPC[name]


def host_argv(rpc: str, outform: str) -> list:
    argv = onchain_argv("armed", rpc, engine="host")
    return argv[:argv.index("-o")] + ["-o", outform] + \
        argv[argv.index("-o") + 2:]


@pytest.mark.parametrize("outform", ["json", "text"])
def test_analyze_address_on_the_host_is_the_jax_analysis(outform):
    """`analyze -a --rpc --engine host`: the kill armed on the chain, so
    SWC-106 at one transaction; the JAX CLI's report and requests."""
    from test_torch_cli import mask_text

    got = {}
    with onchain_chain(1) as chain:
        for side in (JAX, PORT):
            chain.clear()
            exit_code, out, _ = cli_main(side, host_argv(chain.rpc, outform))
            got[side.name] = (exit_code, out, chain.log)
    assert got["port"][0] == got["jax"][0] == 1
    assert got["port"][2] == got["jax"][2] == EXPECTED_ONCHAIN_RPC["armed"]
    if outform == "json":
        report = json.loads(got["port"][1])
        report_parity(report, json.loads(got["jax"][1]), same_pool=False)
        assert [issue["swc-id"] for issue in report["issues"]] == ["106"]
    else:
        assert mask_text(got["port"][1]) == mask_text(got["jax"][1])
        assert "SWC ID: 106" in got["port"][1]


@pytest.fixture
def sixteen_lanes(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_LANES", "16")
    pf.configure(lanes=16, device="cpu")
    yield
    pf.reset()


def test_analyze_address_on_the_device_is_the_jax_analysis(sixteen_lanes):
    """`analyze -a --rpc --engine tpu` with the kill armed, on the port's
    twins at 16 lanes and the JAX frontier at 16 lanes: the report, the
    `frontier:` line word for word, the requests; the slot faulted in from
    the chain."""
    got = {}
    with onchain_chain(1) as chain:
        for side in (JAX, PORT):
            chain.clear()
            exit_code, out, log = cli_main(
                side, onchain_argv("armed", chain.rpc))
            lines = [line for line in log.splitlines()
                     if line.startswith("frontier: ")]
            got[side.name] = (exit_code, json.loads(out), lines, chain.log)
    port, jax = got["port"], got["jax"]
    assert port[0] == jax[0] == 1
    report_parity(port[1], jax[1], same_pool=False)
    assert port[2] == jax[2] and len(port[2]) == 1
    assert int(FRONTIER_LINE.match(port[2][0]).group(2)) > 0
    assert port[3] == jax[3] == EXPECTED_ONCHAIN_RPC["armed"]


def test_a_failing_chain_fails_both_clis_alike(tmp_path):
    """`eth_getStorageAt` answered with a JSON-RPC error: RPCError (no
    ValueError, so the storage read does not swallow it) ends the
    contract's analysis in both CLIs, whose analyzer logs its traceback and
    reports no issue: one exit code, one report and one last line of
    stderr, the exception's module up to its package's name."""
    env = dict(os.environ, HOME=str(tmp_path), PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    got = {}
    with onchain_chain(1, fail=("eth_getStorageAt",)) as chain:
        for side, package in (("jax", "mythril_tpu"),
                              ("port", "mythril_tpu_torch")):
            chain.clear()
            proc = subprocess.run(
                [sys.executable, "-m", package,
                 *host_argv(chain.rpc, "json")],
                capture_output=True, text=True, cwd=str(tmp_path), env=env,
                timeout=300)
            last = proc.stderr.strip().splitlines()[-1]
            got[side] = (proc.returncode,
                         last.replace("mythril_tpu_torch.", "mythril_tpu."),
                         proc.stdout, chain.log)
    assert got["port"] == got["jax"]
    exit_code, last, stdout, log = got["port"]
    assert exit_code == 0 and json.loads(stdout)["issues"] == []
    assert last == ("mythril_tpu.ethereum.rpc.RPCError: the stub chain "
                    "does not serve eth_getStorageAt")
    assert log == EXPECTED_ONCHAIN_RPC["armed"]


def test_engine_tpu_without_a_card_refuses(capsys):
    """No card and no CPU device configured: exit 2 naming the CUDA
    device, no report."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --engine tpu runs on it")
    pf.reset()
    with onchain_chain(1) as chain:
        exit_code, out, _ = cli_main(PORT, onchain_argv("armed", chain.rpc))
    assert exit_code == 2 and out == ""
    assert "CUDA device" in capsys.readouterr().err


def test_chip_smoke_constants_are_the_jax_analyses(monkeypatch):
    """EXPECTED_ONCHAIN and EXPECTED_ONCHAIN_RPC are what the JAX CLI at
    128 lanes gives on ONCHAIN_RUNS, and the onchain_tpu phase's own
    checks (`onchain_run`, `check_onchain`) pass the port's CLI on its
    twins at the same 128 lanes."""
    monkeypatch.setenv("MYTHRIL_TPU_LANES", "128")
    pf.configure(device="cpu")
    try:
        for name, (armed, _) in ONCHAIN_RUNS.items():
            with onchain_chain(armed) as chain:
                exit_code, out, log = cli_main(
                    JAX, onchain_argv(name, chain.rpc))
                assert chip_smoke.tpu_summary(json.loads(out), exit_code,
                                              log) == EXPECTED_ONCHAIN[name]
                assert chain.log == EXPECTED_ONCHAIN_RPC[name], name
            with onchain_chain(armed) as chain:
                summary, record, log = chip_smoke.onchain_run(name, chain)
            chip_smoke.check_onchain(name, summary, log)
            assert record["rpc_calls"] == len(log) and not record[
                "incomplete"]
    finally:
        pf.reset()
