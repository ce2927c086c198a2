"""The port's CLI (`python -m mythril_tpu_torch`) against the JAX
package's (`python -m mythril_tpu`), each in a subprocess with the same
arguments and a HOME of the test's own (the JAX package's signature
database lives under HOME; the port's is in memory).

- `analyze -o json` on chip_smoke.py's ANALYZE_RUNS (KILLBILLY with all
  modules at two transactions, SAFE_KILL, the tx.origin contract) and on
  KILLBILLY's runtime code (`--bin-runtime`): the exit code (0 clean, 1
  issues found) and the report, by tests/_torch_engine.py's
  `report_parity` with each port witness replayed (a subprocess's clause
  pool is not visible here);
- `-o text`, `jsonv2` and `markdown` on the tx.origin contract: equal
  with the witness values masked (its descriptions hold no symbolic
  text), and the witness in the port's output replayed;
- `list-detectors`, `disassemble`, `function-to-hash`, `hash-to-address`
  and `safe-functions` byte for byte;
- `--engine tpu` and `optimize --solver jax` without a card exit 2,
  naming the CUDA device, before any contract is analyzed (on-chain,
  Solidity and foundry input: tests/test_torch_rpc.py and
  tests/test_torch_solidity.py);
- `optimize`/`opt` (text, JSON but for `wall_ms`, `--code-out`) byte for
  byte on tests/test_superopt.py's SYNTHETIC, under `--solver cdcl` and,
  on the port's CPU twin of K11, `--solver jax`; `concolic` with the
  JAX CLI's exit code and last line of stderr;
- `--metrics-out` and `--trace-out` write the registry's snapshot and the
  run's trace, equal to the JAX CLI's but for the clock readings;
- `--solver jax` (the port's SAT lane on its twin, through a wrapper that
  configures it on the CPU), `--checkpoint`, `--resume` and `--fleet`
  (one contract: run as without it) give the JAX CLI's report on the
  tx.origin contract;
- chip_smoke.py's EXPECTED_ANALYZE recomputed from the JAX CLI's reports,
  and its own check of the port's."""

import json
import os
import re
import subprocess
import sys

import pytest

import chip_smoke
from _torch_engine import PORT, replay_reaches, report_parity

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PACKAGES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}


def creation_hex(contract) -> str:
    return PORT.asm.creation_wrapper(
        PORT.asm.assemble(PORT.asm.dispatcher(contract))).hex()


#: `analyze` runs beyond chip_smoke.py's: KILLBILLY's runtime code
RUNTIME_ARGV = ["analyze", "-c",
                PORT.asm.assemble(PORT.asm.dispatcher(chip_smoke.KILLBILLY))
                .hex(), "--bin-runtime", "-t", "2", "-o", "json"]


def analyze_argv(name: str) -> list:
    if name == "killbilly_runtime":
        return RUNTIME_ARGV
    return chip_smoke.analyze_argv(*chip_smoke.ANALYZE_RUNS[name])


def tx_origin_argv(outform: str) -> list:
    argv = analyze_argv("tx_origin")
    return argv[:argv.index("-o")] + ["-o", outform]


#: the port's CLI with its SAT lane on the CPU twin, the device clause cap
#: at 4096 (the JAX package's CPU gates shrink MYTHRIL_TPU_DEVICE_CLAUSE_CAP
#: alike: larger queries go through the dispatch to the CDCL), on one torch
#: thread (the twin is many small ops: beside the other test workers a
#: pool of threads an op takes it from seconds to minutes)
PORT_ON_THE_CPU = (
    "import sys, torch; torch.set_num_threads(1); "
    "from mythril_tpu_torch.smt.solver import dispatch; "
    "dispatch.configure(device='cpu', clause_cap=4096); "
    "from mythril_tpu_torch.interfaces import cli; "
    "sys.exit(cli.main(sys.argv[1:]))")


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """cli(side, argv) -> CompletedProcess, each command run once."""
    home = str(tmp_path_factory.mktemp("home"))
    env = dict(os.environ, HOME=home, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    done = {}

    def run(side, argv):
        key = (side, tuple(argv))
        if key not in done:
            command = ([sys.executable, "-c", PORT_ON_THE_CPU]
                       if side == "port-cpu"
                       else [sys.executable, "-m", PACKAGES[side]])
            done[key] = subprocess.run(
                [*command, *argv], capture_output=True, text=True, cwd=home,
                env=env, timeout=900)
        return done[key]

    return run


def both(cli, argv):
    return cli("port", argv), cli("jax", argv)


ANALYZE_CASES = sorted(chip_smoke.ANALYZE_RUNS) + ["killbilly_runtime"]


@pytest.mark.parametrize("name", ANALYZE_CASES)
def test_analyze_json(cli, name):
    port, jax = both(cli, analyze_argv(name))
    assert port.returncode == jax.returncode, port.stderr
    report = json.loads(port.stdout)
    assert port.returncode == (1 if report["issues"] else 0)
    report_parity(report, json.loads(jax.stdout), same_pool=False)


def test_exit_codes(cli):
    assert cli("port", analyze_argv("safe_kill")).returncode == 0
    assert cli("port", analyze_argv("killbilly")).returncode == 1


#: the witness in text output: caller, calldata and value of each step
TEXT_STEP = re.compile(r"^(\d+): (CREATE|CALL) Caller: \[(0x[0-9a-f]+)\], "
                       r"function: (\S+), txdata: (0x[0-9a-f]*), "
                       r"value: (0x[0-9a-f]+)$", re.M)


def mask_text(text: str) -> str:
    return TEXT_STEP.sub(r"\1: \2 Caller: [?], function: \4, txdata: ?, "
                         r"value: ?", text)


def mask_sequence(sequence: dict) -> dict:
    steps = [{**step, "input": "?", "calldata": "?", "value": "?",
              "origin": "?", "gasPrice": "?"} for step in sequence["steps"]]
    accounts = {address: {**account, "balance": "?"} for address, account
                in sequence["initialState"]["accounts"].items()}
    return {"initialState": {"accounts": accounts}, "steps": steps}


def replay_each(issues) -> None:
    """Every (steps, initial accounts, address) witness reaches its address
    on the port's host engine."""
    assert issues
    for steps, accounts, address in issues:
        assert replay_reaches(steps, accounts, address), (steps, address)


def test_text_output(cli):
    port, jax = both(cli, tx_origin_argv("text"))
    assert port.returncode == jax.returncode == 1
    assert mask_text(port.stdout) == mask_text(jax.stdout)
    # the text gives no callee, gas or initial state: those come from the
    # port's json report of the same analysis, whose are held to JAX's
    issue = json.loads(cli("port", analyze_argv("tx_origin")).stdout)[
        "issues"][0]
    sequence = issue["tx_sequence"]
    steps = [{**shape, "origin": caller, "input": data, "value": value}
             for shape, (_, _, caller, _, data, value)
             in zip(sequence["steps"], TEXT_STEP.findall(port.stdout))]
    assert len(steps) == len(sequence["steps"])
    replay_each([(steps, sequence["initialState"]["accounts"],
                  issue["address"])])


def test_jsonv2_output(cli):
    port, jax = both(cli, tx_origin_argv("jsonv2"))
    assert port.returncode == jax.returncode == 1
    port_issues = json.loads(port.stdout)[0]["issues"]

    def masked(stdout):
        report = json.loads(stdout)
        for issue in report[0]["issues"]:
            issue["extra"]["testCases"] = [
                mask_sequence(case) for case in issue["extra"]["testCases"]]
        return report

    assert masked(port.stdout) == masked(jax.stdout)
    replay_each([(case["steps"], case["initialState"]["accounts"],
                  issue["locations"][0]["bytecodeOffset"])
                 for issue in port_issues
                 for case in issue["extra"]["testCases"]])


def test_markdown_output(cli):
    port, jax = both(cli, tx_origin_argv("markdown"))
    assert port.returncode == jax.returncode == 1
    assert port.stdout == jax.stdout


@pytest.mark.parametrize("argv", [
    ["list-detectors"],
    ["disassemble", "-c", creation_hex(chip_smoke.KILLBILLY)],
    ["d", "-c", PORT.asm.assemble(PORT.asm.dispatcher(
        chip_smoke.TX_ORIGIN)).hex()],
    ["function-to-hash", "commencekilling()"],
    ["hash-to-address", "0x7c11da20"],
    ["hash-to-address", "0x00000000"],
    ["safe-functions", "-c", creation_hex(chip_smoke.TX_ORIGIN), "-t", "1"],
], ids=["list-detectors", "disassemble", "d", "function-to-hash",
        "hash-to-address", "hash-to-address-unknown", "safe-functions"])
def test_byte_for_byte(cli, argv):
    port, jax = both(cli, argv)
    assert (port.returncode, port.stdout) == (jax.returncode, jax.stdout)
    assert port.stdout


def test_version(cli):
    from mythril_tpu_torch import __version__

    port, jax = both(cli, ["version"])
    assert port.stdout == f"myth-tpu-torch {__version__}\n"
    assert jax.stdout == f"myth-tpu {__version__}\n"


TX_ORIGIN_CODE = creation_hex(chip_smoke.TX_ORIGIN)


@pytest.mark.parametrize("flag", ["--metrics-out", "--trace-out"])
def test_observability_files(cli, tmp_path_factory, flag):
    """`--metrics-out` and `--trace-out`, which exited 2 until the port had
    its own registry and tracer, write the file they name: the same
    snapshot as the JAX CLI's but for its clock readings, and a trace with
    the JAX CLI's spans (tests/_torch_observe.py)."""
    from _torch_observe import deterministic, load_events, span_names

    tmp = tmp_path_factory.mktemp(flag.strip("-"))
    out = {}
    for side in ("port", "jax"):
        path = f"{tmp}/{side}.json"
        proc = cli(side, ["analyze", "-c", TX_ORIGIN_CODE, "-t", "1", "-o",
                          "json", flag, path])
        assert proc.returncode == 1, proc.stderr[-2000:]
        with open(path, encoding="utf-8") as handle:
            out[side] = json.load(handle)
    if flag == "--metrics-out":
        assert deterministic(out["port"]) == deterministic(out["jax"])
        assert out["port"]["solver.queries"] > 0
        assert out["port"]["cfa.blocks"] > 0
    else:
        names = span_names(load_events(f"{tmp}/port.json"))
        assert names == span_names(load_events(f"{tmp}/jax.json"))
        assert names[("X", "svm.tx")] == 1
        assert names[("X", "analyze.contract")] == 1
        assert out["port"]["otherData"]["engine"] == "host"


#: the paths this PR opened, once seams: (flag, the port side that runs it)
PORTED = [(["--solver", "jax"], "port-cpu"),
          (["--checkpoint", "{tmp}/checkpoint"], "port"),
          (["--resume", "{tmp}/checkpoint"], "port"),
          (["--fleet"], "port")]


@pytest.mark.parametrize("flags, side", PORTED,
                         ids=[flags[0] for flags, _ in PORTED])
def test_ported_paths_give_the_jax_report(cli, tmp_path_factory, flags,
                                          side):
    """`--solver jax`, `--checkpoint`, `--resume` and `--fleet`, which
    exited 2 until they were ported, analyze the tx.origin contract to the
    JAX CLI's report (`report_parity`, the witness replayed): `--solver
    jax` against the JAX CLI's default solver (the solver changes no
    verdict); a checkpoint run against the JAX CLI's checkpoint run, each
    leaving its host pickle; a resume from the port's own checkpoint,
    after the one transaction, against the JAX CLI's resume from its own;
    `--fleet` with one contract (run as without it) against the JAX CLI's
    `--fleet`."""
    tmp = tmp_path_factory.mktemp(flags[0].strip("-"))
    base = ["analyze", "-c", TX_ORIGIN_CODE, "-t", "1", "-o", "json"]
    if flags[0] == "--resume":
        for name in ("port", "jax"):
            written = cli(name, base + ["--checkpoint", f"{tmp}/{name}"])
            assert written.returncode == 1, written.stderr[-2000:]
    def named(name):
        return [arg.replace("{tmp}/checkpoint", f"{tmp}/{name}")
                for arg in flags]

    verbose = ["-v", "4"] if flags[0] == "--resume" else []
    port = cli(side, verbose + base + named("port"))
    jax_flags = [] if flags[0] == "--solver" else named("jax")
    jax = cli("jax", base + jax_flags)
    assert port.returncode == jax.returncode == 1, port.stderr[-2000:]
    report = json.loads(port.stdout)
    report_parity(report, json.loads(jax.stdout), same_pool=False)
    assert report["error"] is None and not report["issues"] == []
    if flags[0] == "--checkpoint":
        assert os.path.exists(f"{tmp}/port") and os.path.exists(f"{tmp}/jax")
        assert not os.path.exists(f"{tmp}/port.device.npz")
    if flags[0] == "--resume":
        assert "resumed host checkpoint: tx 1" in port.stderr


def test_engine_tpu_without_a_card_refuses(cli, tmp_path):
    """`--engine tpu` runs on the CUDA card: without one it exits 2 with
    `device.resolve`'s error, naming the CUDA device, before any contract
    is analyzed (no report), never on the host or the CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: --engine tpu runs on it")
    before = sorted(os.listdir(tmp_path))
    proc = cli("port", ["analyze", "-c", TX_ORIGIN_CODE, "-t", "1",
                        "--engine", "tpu", "-o", "json"])
    assert proc.returncode == 2, (proc.stdout, proc.stderr)
    assert "CUDA device" in proc.stderr
    assert proc.stdout == ""
    assert sorted(os.listdir(tmp_path)) == before


def test_chip_smoke_constants_are_the_jax_reports(cli):
    """chip_smoke.py's analyze phase holds the port's CLI to
    EXPECTED_ANALYZE: the JAX CLI's reports give those summaries, and the
    phase's own check (which raises on a difference) passes the port's."""
    for name in chip_smoke.ANALYZE_RUNS:
        jax = cli("jax", analyze_argv(name))
        assert chip_smoke.analyze_summary(
            json.loads(jax.stdout), jax.returncode) == \
            chip_smoke.EXPECTED_ANALYZE[name], name
        port = cli("port", analyze_argv(name))
        chip_smoke.check_analyze(name, json.loads(port.stdout),
                                 port.returncode)


SYNTHETIC_CODE = chip_smoke.OPTIMIZE_CODES["synthetic"]


def without_wall(stdout: str) -> dict:
    report = json.loads(stdout)
    del report["wall_ms"]
    return report


@pytest.mark.parametrize("side, solver", [("port", "cdcl"),
                                          ("port-cpu", "jax")],
                         ids=["cdcl", "jax"])
def test_optimize_gives_the_jax_output(cli, tmp_path_factory, side, solver):
    """`opt -o json --code-out` prints and writes what the JAX CLI does,
    the JSON but for its wall, and under `cdcl` so does `optimize`'s text;
    `--solver jax` on the port's twin of K11 against the JAX CLI's own
    lane on the CPU (one run a side: each compiles its lane), whose
    rewrites are the device's."""
    tmp = tmp_path_factory.mktemp(f"optimize-{solver}")
    out = {}
    for name in ("port", "jax"):
        runner = side if name == "port" else "jax"
        as_json = cli(runner, ["opt", "-c", SYNTHETIC_CODE, "--solver",
                               solver, "-o", "json",
                               "--code-out", f"{tmp}/{name}.hex"])
        assert as_json.returncode == 0, as_json.stderr[-2000:]
        text = cli(runner, ["optimize", "-c", SYNTHETIC_CODE]) \
            if solver == "cdcl" else None
        assert text is None or text.returncode == 0
        with open(f"{tmp}/{name}.hex", encoding="utf-8") as handle:
            out[name] = (without_wall(as_json.stdout), handle.read(),
                         text and text.stdout)
    assert out["port"] == out["jax"]
    report, code_out, text = out["port"]
    assert code_out == report["code_out"] + "\n" and report["rewrites"]
    assert text is None or report["code_out"] in text
    proofs = {rewrite["proof"] for rewrite in report["rewrites"]}
    assert ("device" if solver == "jax" else "host") in proofs


def test_optimize_jax_without_a_card_refuses(cli, tmp_path):
    """`optimize --solver jax` proves on the CUDA card: without one it
    exits 2 with `device.resolve`'s error, naming the CUDA device, before
    it prints or writes anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: --solver jax runs on it")
    proc = cli("port", ["optimize", "-c", SYNTHETIC_CODE, "--solver", "jax",
                        "--code-out", f"{tmp_path}/out.hex"])
    assert proc.returncode == 2, (proc.stdout, proc.stderr)
    assert "CUDA device" in proc.stderr
    assert proc.stdout == ""
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("engine", ["oracle", "lockstep"])
def test_concolic_fails_as_the_jax_cli(cli, tmp_path_factory, engine):
    """`concolic` on tests/test_torch_concolic.py's ConcreteData, asked to
    flip its JUMPI: the same exit code and last line of stderr as the JAX
    CLI (both raise the AttributeError of ROADMAP C's concolic entry)."""
    from test_torch_concolic import JUMPI, concrete_data

    path = tmp_path_factory.mktemp(f"concolic-{engine}") / "trace.json"
    path.write_text(json.dumps(concrete_data("call")))
    argv = ["concolic", str(path), "--branches", str(JUMPI),
            "--engine", engine]
    port, jax = both(cli, argv)
    last = [proc.stderr.strip().splitlines()[-1] for proc in (port, jax)]
    assert (port.returncode, last[0]) == (jax.returncode, last[1])
    assert port.returncode == 1 and "persist_to_world_state" in last[0]
