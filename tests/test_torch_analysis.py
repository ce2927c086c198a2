"""The port's analyzer (mythril_tpu_torch/mythril, analysis/, the plugins
and the 18 detection modules) against the JAX package's: the eight
contracts of tests/test_analysis.py, each with the modules and
transaction count its test uses, analyzed by each package's
MythrilAnalyzer as its `analyze` CLI runs it (bfs, max_depth 128,
loop_bound 3, budgets neither side reaches) give the same `-o json`
report.

The rule (tests/_torch_engine.py `report_parity`): every issue's
swc-id, title, severity, contract, function, address, gas bounds, steps
and their callees, the set and order of the issues and `incomplete` are
compared exactly, the description as sorted tokens; the witness (each
step's input, value, origin and gas price, and the initial balances)
exactly where the two packages blasted the same clause pool, else the
port's witness is replayed concretely on the port's host engine and must
reach its issue's address. Each analysis runs once a side (a
module-scoped cache), and the port's reports are also held to
tests/test_analysis.py's own assertions."""

import pytest

from _torch_engine import PORT, analyze_report, report_parity, run_both
from chip_smoke import KILLBILLY, SAFE_KILL, TX_ORIGIN

#: the contracts of tests/test_analysis.py (its KILLBILLY, SAFE_KILL and
#: tx.origin contract are chip_smoke.py's, held equal below)
CASES = {
    "unprotected_selfdestruct": (KILLBILLY, ["AccidentallyKillable"], 2),
    "protected_selfdestruct": (SAFE_KILL, ["AccidentallyKillable"], 2),
    "tx_origin": (TX_ORIGIN, ["TxOrigin"], 1),
    "exception_state": ({"boom()": "INVALID"}, ["Exceptions"], 1),
    "ether_thief": ({
        "withdraw()":
            "PUSH1 0x00\nPUSH1 0x00\nPUSH1 0x00\nPUSH1 0x00\n"
            "SELFBALANCE\nCALLER\nPUSH2 0xffff\nCALL\nPOP\nSTOP",
    }, ["EtherThief"], 2),
    "unchecked_retval": ({
        "send()":
            "PUSH1 0x00\nPUSH1 0x00\nPUSH1 0x00\nPUSH1 0x00\nPUSH1 0x00\n"
            "CALLER\nPUSH2 0xffff\nCALL\nPOP\nSTOP",
    }, ["UncheckedRetval"], 1),
    "delegatecall": ({
        "exec(address)":
            "PUSH1 0x04\nCALLDATALOAD\n"
            "PUSH1 0x00\nPUSH1 0x00\nPUSH1 0x00\nPUSH1 0x00\n"
            "DUP5\nGAS\nDELEGATECALL\nPOP\nPOP\nSTOP",
    }, ["ArbitraryDelegateCall"], 1),
    "integer_overflow": ({
        "add(uint256)":
            "PUSH1 0x00\nSLOAD\nPUSH1 0x04\nCALLDATALOAD\nADD\n"
            "PUSH1 0x00\nSSTORE\nSTOP",
    }, ["IntegerArithmetics"], 2),
}


@pytest.fixture(scope="module")
def analyses():
    """{case: {"jax": analysis, "port": analysis}}, each run once."""
    done = {}

    def analysis(case):
        if case not in done:
            contract, modules, transaction_count = CASES[case]
            code = PORT.asm.creation_wrapper(
                PORT.asm.assemble(PORT.asm.dispatcher(contract)))
            done[case] = run_both(analyze_report, code, modules,
                                  transaction_count)
        return done[case]

    return analysis


def port_issues(analyses, case):
    return analyses(case)["port"]["json"]["issues"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_parity(analyses, case):
    observed = analyses(case)
    port, jax = observed["port"], observed["jax"]
    assert port["exceptions"] == jax["exceptions"] == []
    report_parity(port["json"], jax["json"], port["pool"] == jax["pool"])


def test_contracts_are_test_analysis_contracts():
    import test_analysis

    assert (KILLBILLY, SAFE_KILL) == (test_analysis.KILLBILLY,
                                      test_analysis.SAFE_KILL)
    assert TX_ORIGIN == {
        "check()": "ORIGIN\nPUSH1 0x42\nEQ\nPUSH @ok\nJUMPI\nSTOP\n"
                   "ok:\nJUMPDEST\nSTOP"}


def test_unprotected_selfdestruct_found(analyses):
    issues = port_issues(analyses, "unprotected_selfdestruct")
    assert len(issues) == 1
    issue = issues[0]
    assert issue["swc-id"] == "106"
    assert issue["title"] == "Unprotected Selfdestruct"
    steps = issue["tx_sequence"]["steps"]
    assert len(steps) == 3  # creation + activate + kill
    selector = PORT.asm.selector
    assert steps[1]["input"].startswith(
        "0x%08x" % selector("activatekillability()"))
    assert steps[2]["input"].startswith(
        "0x%08x" % selector("commencekilling()"))


def test_protected_selfdestruct_not_found(analyses):
    assert port_issues(analyses, "protected_selfdestruct") == []


@pytest.mark.parametrize("case, swc_id", [
    ("tx_origin", "115"), ("exception_state", "110")])
def test_one_issue_found(analyses, case, swc_id):
    issues = port_issues(analyses, case)
    assert [issue["swc-id"] for issue in issues] == [swc_id]


@pytest.mark.parametrize("case, swc_id", [
    ("ether_thief", "105"), ("unchecked_retval", "104"),
    ("delegatecall", "112"), ("integer_overflow", "101")])
def test_issue_found(analyses, case, swc_id):
    assert any(issue["swc-id"] == swc_id
               for issue in port_issues(analyses, case))
