"""The port's Solidity front end (frontends/solidity.py) and its Solidity
and foundry input against the JAX package's, on the CPU, with
chip_smoke.py's stub solc (`solidity_fixture`: an executable script named
`solc` that prints canned standard-JSON for KillBilly.sol, its source
text beside it, one source map entry an instruction and a small AST, and
a foundry project holding the same contract's artifact).

- `decode_srcmap` over a table of maps, inherited and empty fields too;
- `from_standard_json` on the canned output: the contracts, their code,
  source maps, sources, source texts and AST features;
- `get_source_info` at every instruction, creation and runtime;
- `_strip_unlinked`;
- `get_contracts_from_foundry` on the fixture, and without `out/`;
- `get_solc_json` with the stub: its output, a non-zero exit, an error
  in the output, and no binary on PATH, each with the JAX message;
- both CLIs in this process (tests/_torch_engine.py `cli_main`) from the
  fixture's directory with the stub first on PATH: `analyze
  KillBilly.sol` (text, json, markdown), `analyze KillBilly.sol:KillBilly`
  and `foundry`; and `analyze Token.sol` with no solc on PATH
  (subprocesses: one exit code, one last stderr line up to the package's
  name);
- chip_smoke's EXPECTED_SOLIDITY recomputed with the JAX CLI at 128 lanes
  and the solidity_tpu phase's own check passed by the port on its
  twins."""

import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from _torch_engine import JAX, PORT, cli_main, report_parity
from chip_smoke import (EXPECTED_SOLIDITY, SOLIDITY_CONTRACT, SOLIDITY_FILE,
                        SOLIDITY_RUNS, killbilly_srcmap,
                        killbilly_standard_json, solidity_fixture)
from mythril_tpu.frontends import solidity as jsolidity
from mythril_tpu_torch.frontends import solidity as psolidity
from mythril_tpu_torch.parallel import frontier as pf

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SOLIDITY = {"jax": jsolidity, "port": psolidity}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fixture_dir(tmp_path, monkeypatch):
    """The fixture's directory as the working directory, its stub solc
    first on PATH."""
    paths = solidity_fixture(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", paths["bin"] + os.pathsep
                       + os.environ.get("PATH", ""))
    return paths


def outcome(call):
    """A call's result, or its exception's type name and message."""
    try:
        return ("ok", call())
    except Exception as error:
        return (type(error).__name__, str(error))


SRCMAPS = ["", "1:2:0:-", "1:2:0;;3", ";:4", "5::1:i;6:7", "0:10:-1:-",
           "1:2:0:-:0;:::o", "10:20:1;;;:5;2", "7", ";;",
           killbilly_srcmap(chip_smoke.KILLBILLY_SNIPPETS)]


@pytest.mark.parametrize("srcmap", SRCMAPS)
def test_decode_srcmap_is_the_jax_decode(srcmap):
    assert psolidity.decode_srcmap(srcmap) == jsolidity.decode_srcmap(srcmap)


def contract_view(contract) -> dict:
    """What a SolidityContract holds: names, code, maps, sources, texts
    and features."""
    return {"name": contract.name, "input_file": contract.input_file,
            "filename": contract.filename, "code": contract.code,
            "creation_code": contract.creation_code,
            "srcmap": contract.srcmap,
            "creation_srcmap": contract.creation_srcmap,
            "sources": contract.sources,
            "source_texts": contract.source_texts,
            "features": contract.features}


def source_infos(contract, constructor: bool) -> list:
    disassembly = contract.creation_disassembly if constructor \
        else contract.disassembly
    out = []
    for instruction in disassembly.instruction_list:
        info = contract.get_source_info(instruction.address, constructor)
        out.append(info and (info.offset, info.length, info.file_index,
                             info.filename, info.lineno, info.code))
    return out


def test_standard_json_contracts_are_the_jax_contracts(fixture_dir):
    """The canned output through `from_standard_json` (all contracts, and
    by name), and `get_source_info` at every creation and runtime
    instruction."""
    output = killbilly_standard_json()
    got = {}
    for side, module in SOLIDITY.items():
        contracts = list(module.SolidityContract.from_standard_json(
            output, SOLIDITY_FILE))
        named = list(module.SolidityContract.from_standard_json(
            output, SOLIDITY_FILE, contract_name="Other"))
        got[side] = ([contract_view(c) for c in contracts], named,
                     [(source_infos(c, False), source_infos(c, True))
                      for c in contracts])
    assert got["port"] == got["jax"]
    views, named, (infos,) = got["port"]
    assert named == [] and len(views) == 1
    assert views[0]["source_texts"] == {0: chip_smoke.KILLBILLY_SOL}
    assert views[0]["features"]["commencekilling"]["contains_selfdestruct"]
    runtime, creation = infos
    assert None not in runtime
    assert runtime[-1][3:] == (SOLIDITY_FILE, 13,
                               "selfdestruct(payable(msg.sender))")
    assert creation[0][4] == 4 and None not in creation


@pytest.mark.parametrize("bytecode", [
    "6060", "__$abc$__", "73__LibName_____________________________63",
    "", "$$__"])
def test_strip_unlinked_is_the_jax_strip(bytecode):
    assert psolidity._strip_unlinked(bytecode) == \
        jsolidity._strip_unlinked(bytecode)


def test_foundry_contracts_are_the_jax_contracts(fixture_dir, tmp_path):
    got = {}
    for side, module in SOLIDITY.items():
        contracts = list(module.get_contracts_from_foundry(
            fixture_dir["foundry"]))
        got[side] = ([contract_view(c) for c in contracts],
                     [source_infos(c, False) for c in contracts],
                     outcome(lambda: list(module.get_contracts_from_foundry(
                         str(tmp_path / "empty")))))
    assert got["port"] == got["jax"]
    views, infos, missing = got["port"]
    assert [view["name"] for view in views] == [SOLIDITY_CONTRACT]
    assert set(infos[0]) == {None}
    assert missing[0] == "SolcError" and "no foundry output" in missing[1]


#: stub solc variants: a non-zero exit with a message, and an output with
#: an error beside a warning
FAILING_SOLC = {
    "solc-exit3": "import sys\nsys.stdin.read()\n"
                  "sys.stderr.write('Error: boom\\n')\nsys.exit(3)\n",
    "solc-error": "import json, sys\nsys.stdin.read()\n"
                  "print(json.dumps({'errors': ["
                  "{'severity': 'warning', 'formattedMessage': 'W'}, "
                  "{'severity': 'error', 'formattedMessage': 'E1'}, "
                  "{'severity': 'error', 'message': 'E2'}]}))\n",
}


def test_get_solc_json_is_the_jax_driver(fixture_dir):
    """The stub's output, a non-zero exit, an error in the output and a
    binary missing from PATH, each with the JAX message."""
    for name, body in FAILING_SOLC.items():
        path = os.path.join(fixture_dir["bin"], name)
        with open(path, "w") as handle:
            handle.write(f"#!{sys.executable}\n{body}")
        os.chmod(path, 0o755)
    got = {}
    for side, module in SOLIDITY.items():
        got[side] = [outcome(lambda: module.get_solc_json(
                         SOLIDITY_FILE, solc_binary=binary))
                     for binary in ("solc", *FAILING_SOLC, "solc-absent")]
    assert got["port"] == got["jax"]
    ok, exit3, error, absent = got["port"]
    assert ok == ("ok", killbilly_standard_json())
    assert exit3 == ("SolcError", "solc exited 3: Error: boom\n")
    assert error[0] == "SolcError" and "E1" in error[1] and "W" not in \
        error[1]
    assert absent[0] == "SolcNotFound" and "solc-absent" in absent[1]


def issue_sources(report: dict) -> list:
    return [[issue.get("filename"), issue.get("lineno"), issue.get("code")]
            for issue in report["issues"]]


CLI_CASES = {
    "json": ["analyze", SOLIDITY_FILE, "-t", "2", "-o", "json"],
    "text": ["analyze", SOLIDITY_FILE, "-t", "2", "-o", "text"],
    "markdown": ["analyze", SOLIDITY_FILE, "-t", "2", "-o", "markdown"],
    "named": ["analyze", f"{SOLIDITY_FILE}:{SOLIDITY_CONTRACT}", "-t", "2",
              "-o", "json"],
    "foundry": ["foundry", "--project-root", "foundry", "-t", "2", "-o",
                "json"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_gives_the_jax_source_mapped_report(fixture_dir, case):
    """Both CLIs on the host engine (AccidentallyKillable: SWC-106 at two
    transactions): one exit code and the JAX report, its issues' file,
    line and code included (none from a foundry artifact, which names no
    source)."""
    from test_torch_cli import mask_text

    argv = [*CLI_CASES[case], "-m", "AccidentallyKillable"]
    got = {side.name: cli_main(side, argv)[:2] for side in (JAX, PORT)}
    assert got["port"][0] == got["jax"][0] == 1
    port, jax = got["port"][1], got["jax"][1]
    if case == "text":
        assert mask_text(port) == mask_text(jax)
        assert f"In file: {SOLIDITY_FILE}:13" in port
    elif case == "markdown":
        assert port == jax
    else:
        report = json.loads(port)
        report_parity(report, json.loads(jax), same_pool=False)
        assert issue_sources(report) == issue_sources(json.loads(jax))
        expected = EXPECTED_SOLIDITY[
            "foundry" if case == "foundry" else "analyze"]["issues"]
        assert issue_sources(report) == [issue[2:] for issue in expected]


def test_no_solc_fails_both_clis_alike(tmp_path):
    """`analyze Token.sol` with no solc on PATH: SolcNotFound escapes both
    CLIs with one exit code and one last line of stderr (up to the
    package's name), and nothing on stdout."""
    (tmp_path / "Token.sol").write_text("contract Token {}\n")
    bare = tmp_path / "bin"
    bare.mkdir()
    env = dict(os.environ, HOME=str(tmp_path), PATH=str(bare),
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    got = {}
    for side, package in (("jax", "mythril_tpu"),
                          ("port", "mythril_tpu_torch")):
        proc = subprocess.run(
            [sys.executable, "-m", package, "analyze", "Token.sol"],
            capture_output=True, text=True, cwd=str(tmp_path), env=env,
            timeout=300)
        last = proc.stderr.strip().splitlines()[-1]
        got[side] = (proc.returncode, proc.stdout,
                     last.replace("mythril_tpu_torch.", "mythril_tpu."))
    assert got["port"] == got["jax"]
    exit_code, stdout, last = got["port"]
    assert exit_code == 1 and stdout == ""
    assert last.startswith(
        "mythril_tpu.frontends.solidity.SolcNotFound: solc binary 'solc' "
        "not found on PATH")


def test_chip_smoke_constants_are_the_jax_analyses(fixture_dir, monkeypatch):
    """EXPECTED_SOLIDITY is what the JAX CLI at 128 lanes gives on
    SOLIDITY_RUNS with `--engine tpu`, and the solidity_tpu phase's own
    run (`solidity_run`) gives it on the port's twins at the same 128
    lanes."""
    monkeypatch.setenv("MYTHRIL_TPU_LANES", "128")
    pf.configure(device="cpu")
    try:
        for name, argv in SOLIDITY_RUNS.items():
            exit_code, out, log = cli_main(JAX, [*argv, "--engine", "tpu"])
            assert chip_smoke.solidity_summary(json.loads(out), exit_code,
                                               log) == EXPECTED_SOLIDITY[name]
            summary, record = chip_smoke.solidity_run(name)
            assert summary == EXPECTED_SOLIDITY[name], name
            assert not record["incomplete"]
    finally:
        pf.reset()
