"""The port's laser plugins, transaction prioritiser and static screens
against the JAX package's: the cases of tests/test_state_merge.py,
tests/test_tx_prioritiser.py and tests/test_summaries.py run on both
packages, the port's results held to the JAX package's and to those
tests' own assertions; and the A/B halves of the cfa, taint and absint
screens on the port alone, with their counters on the port's metric
registry.

Analyses run through each package's MythrilAnalyzer as its CLI runs them
(tests/_torch_engine.py `analyze_report`) and their reports are compared
by `report_parity`: identity fields exactly, descriptions as sorted
tokens, the witness exactly where both sides blasted the same clause
pool, else replayed concretely on the port's engine. Each analysis runs
once (a module-scoped cache)."""

import numpy as np
import pytest

import chip_smoke
import test_tx_prioritiser
from _torch_engine import (JAX, PORT, analyze_report, report_parity,
                           report_view, run_both, run_on)
from mythril_tpu.core import tx_prioritiser as jtx_prioritiser
from mythril_tpu.core.plugin.plugins import state_merge as jstate_merge
from mythril_tpu.core.plugin.plugins import summary as jsummary
from mythril_tpu.core.state import constraints as jconstraints
from mythril_tpu.frontends import features as jfeatures
from mythril_tpu_torch.core import tx_prioritiser as ptx_prioritiser
from mythril_tpu_torch.core.plugin.plugins import state_merge as pstate_merge
from mythril_tpu_torch.core.plugin.plugins import summary as psummary
from mythril_tpu_torch.core.state import constraints as pconstraints
from mythril_tpu_torch.frontends import features as pfeatures

#: each side's modules of these cases, by side name
MODULES = {
    "jax": dict(state_merge=jstate_merge, constraints=jconstraints,
                prioritiser=jtx_prioritiser, features=jfeatures,
                summary=jsummary),
    "port": dict(state_merge=pstate_merge, constraints=pconstraints,
                 prioritiser=ptx_prioritiser, features=pfeatures,
                 summary=psummary)}


def module(side, name):
    return MODULES[side.name][name]


# ---- analyses --------------------------------------------------------------------

KILLBILLY_CODE = PORT.asm.creation_wrapper(
    PORT.asm.assemble(PORT.asm.dispatcher(chip_smoke.KILLBILLY)))
SAFE_KILL_CODE = PORT.asm.creation_wrapper(
    PORT.asm.assemble(PORT.asm.dispatcher(chip_smoke.SAFE_KILL)))
KILLBILLY_RUNTIME = PORT.asm.assemble(
    PORT.asm.dispatcher(chip_smoke.KILLBILLY))

#: name: (code, modules, transaction count, runtime code?, analyzer
#: options), as tests/test_state_merge.py and tests/test_summaries.py
#: analyze (through tests/test_analysis.py's `analyze`), and KILLBILLY's
#: runtime code with all modules for the screens
ANALYSES = {
    "baseline": (KILLBILLY_CODE, ["AccidentallyKillable"], 2, False, {}),
    "merged": (KILLBILLY_CODE, ["AccidentallyKillable"], 2, False,
               {"enable_state_merging": True}),
    "summarized": (KILLBILLY_CODE, ["AccidentallyKillable"], 2, False,
                   {"enable_summaries": True}),
    "safe_summarized": (SAFE_KILL_CODE, ["AccidentallyKillable"], 2, False,
                        {"enable_summaries": True}),
    "screens_on": (KILLBILLY_RUNTIME, None, 2, True, {}),
    "no_cfa": (KILLBILLY_RUNTIME, None, 2, True, {"no_cfa": True}),
    "no_taint": (KILLBILLY_RUNTIME, None, 2, True, {"no_taint": True}),
    "no_absint": (KILLBILLY_RUNTIME, None, 2, True, {"no_absint": True}),
}


def analysis_of(side, name):
    code, modules, transaction_count, runtime, options = ANALYSES[name]
    out = analyze_report(side, code, modules, transaction_count,
                         bin_runtime=runtime, **options)
    plugin = out.pop("plugins").get("symbolic-summaries")
    out["summaries"] = (None if plugin is None else
                        (type(plugin).__name__,
                         [summary.as_dict for summary in plugin.summaries]))
    return out


@pytest.fixture(scope="module")
def analyses():
    """analyses(side, name) -> that side's analysis, each run once."""
    done = {}

    def analysis(side, name):
        if (side.name, name) not in done:
            done[side.name, name] = run_on(side, analysis_of, name)
        return done[side.name, name]

    return analysis


def swc_ids(analysis) -> list:
    return sorted(issue["swc-id"] for issue in analysis["json"]["issues"])


def assert_parity(analyses, name):
    port, jax = analyses(PORT, name), analyses(JAX, name)
    assert port["exceptions"] == jax["exceptions"] == []
    report_parity(port["json"], jax["json"], port["pool"] == jax["pool"])
    return port


# ---- tests/test_state_merge.py ----------------------------------------------------

ADDRESS = 0x0ACE0001


def ws_pair(side):
    """tests/test_state_merge.py's two world states (fresh keccak manager
    and solver backend: run_on resets both)."""
    symbol_factory = side.smt.symbol_factory
    selector = symbol_factory.BitVecSym("merge_sel", 256)
    slot = symbol_factory.BitVecVal(0, 256)
    ws_a = side.state.WorldState()
    ws_a.create_account(balance=0, address=ADDRESS)
    ws_a.constraints.append(selector == 1)
    ws_a.accounts[ADDRESS].storage[slot] = 11
    ws_b = side.state.WorldState()
    ws_b.create_account(balance=0, address=ADDRESS)
    ws_b.constraints.append(selector == 2)
    ws_b.accounts[ADDRESS].storage[slot] = 22
    return selector, ws_a, ws_b


def mergeable(side):
    _, ws_a, ws_b = ws_pair(side)
    return module(side, "state_merge").check_ws_merge_condition(ws_a, ws_b)


def merged_verdicts(side):
    state_merge = module(side, "state_merge")
    Constraints = module(side, "constraints").Constraints
    selector, ws_a, ws_b = ws_pair(side)
    state_merge.merge_states(ws_a, ws_b)
    annotated = bool(list(ws_a.get_annotations(state_merge.MergeAnnotation)))
    value = ws_a.accounts[ADDRESS].storage[
        side.smt.symbol_factory.BitVecVal(0, 256)]
    base = list(ws_a.constraints)
    return annotated, [Constraints(base + extra).is_possible() for extra in (
        [selector == 1, value == 11], [selector == 1, value == 22],
        [selector == 2, value == 22], [selector == 2, value == 11],
        [selector == 1], [selector == 2], [selector == 3])]


def too_different(side):
    _, ws_a, ws_b = ws_pair(side)
    for i in range(20):
        ws_b.constraints.append(
            side.smt.symbol_factory.BitVecSym(f"merge_extra{i}", 256) == i)
    return module(side, "state_merge").check_ws_merge_condition(ws_a, ws_b)


def test_mergeable_pair_detected():
    assert run_both(mergeable) == {"jax": True, "port": True}


def test_merge_preserves_per_branch_storage():
    """Under each selector the merged storage reads its own branch's value
    and never the other's; both branches stay reachable, no third does."""
    want = (True, [True, False, True, False, True, True, False])
    assert run_both(merged_verdicts) == {"jax": want, "port": want}


def test_unmergeable_when_too_different():
    assert run_both(too_different) == {"jax": False, "port": False}


def test_e2e_findings_unchanged_with_merging(analyses):
    merged = assert_parity(analyses, "merged")
    assert swc_ids(merged) == swc_ids(analyses(PORT, "baseline")) == ["106"]


# ---- tests/test_tx_prioritiser.py -------------------------------------------------


def extracted(side):
    return module(side, "features").SolidityFeatureExtractor(
        test_tx_prioritiser.AST).extract_features()


def predictions(side):
    prioritiser = module(side, "prioritiser").RfTxPrioritiser(
        test_tx_prioritiser._Contract(extracted(side)), depth=3)
    return (prioritiser.function_names, prioritiser.__next__(address=None),
            prioritiser.__next__(address=None))


def without_features(side):
    prioritiser = module(side, "prioritiser").RfTxPrioritiser(
        test_tx_prioritiser._Contract(None))
    return prioritiser.model, prioritiser.__next__(address=None)


def heuristic(side):
    prioritiser = module(side, "prioritiser")
    model = prioritiser.HeuristicRiskModel(
        n_functions=2, per_function=len(prioritiser.FEATURE_KEYS))
    static = np.zeros(2 * len(prioritiser.FEATURE_KEYS))
    static[0] = 1.0  # function 0: contains_selfdestruct
    return model.predict_proba(static.reshape(1, -1)).tolist()


def test_feature_extraction():
    observed = run_both(extracted)
    features = observed["port"]
    assert features == observed["jax"]
    assert set(features) == {"kill", "deposit"}
    kill, deposit = features["kill"], features["deposit"]
    assert kill["contains_selfdestruct"] is True
    assert kill["has_owner_modifier"] is True
    assert kill["is_payable"] is False
    assert {"owner", "msg_sender"} <= kill["all_require_vars"]
    assert deposit["is_payable"] is True
    assert deposit["contains_selfdestruct"] is False
    assert "amount" in deposit["all_require_vars"]


def test_prioritiser_predicts_sequences():
    observed = run_both(predictions)
    names, first, second = observed["port"]
    assert observed["port"] == observed["jax"]
    assert len(first) == len(second) == 3
    assert all(0 <= i < 2 for i in first)
    # selfdestruct-bearing kill() ranks first despite the owner modifier
    assert first[0] == names.index("kill")


def test_prioritiser_disabled_without_features():
    assert run_both(without_features) == {"jax": (None, []),
                                          "port": (None, [])}


def test_heuristic_model_shape():
    observed = run_both(heuristic)
    probabilities = np.asarray(observed["port"])
    assert observed["port"] == observed["jax"]
    assert probabilities.shape == (1, 2)
    assert abs(float(probabilities.sum()) - 1.0) < 1e-9
    assert probabilities[0, 0] > probabilities[0, 1]


# ---- tests/test_summaries.py -------------------------------------------------------


def test_killbilly_findings_unchanged(analyses):
    """The 2-tx selfdestruct chain survives summary replay: tx1 records
    the activation summary, tx2's kill validates against it."""
    summarized = assert_parity(analyses, "summarized")
    assert swc_ids(summarized) == swc_ids(analyses(PORT, "baseline")) \
        == ["106"]


def test_safe_contract_still_clean(analyses):
    assert assert_parity(analyses, "safe_summarized")["json"]["issues"] == []


def test_summaries_are_recorded(analyses):
    kind, summaries = analyses(PORT, "summarized")["summaries"]
    assert kind == "SymbolicSummaryPlugin"
    # the activation tx mutates storage -> at least one recorded summary
    assert len(summaries) >= 1 and all(summaries)
    assert (kind, summaries) == analyses(JAX, "summarized")["summaries"]


# ---- the screens' A/B halves, on the port ------------------------------------------


@pytest.mark.parametrize("off", ["no_cfa", "no_taint", "no_absint"])
def test_screen_off_gives_the_same_detections(analyses, off):
    """KILLBILLY's runtime code (where the taint screen skips whole
    modules), all modules, 2 transactions: the same report with the
    screen off as with every screen on (the default run), witnesses by
    the same rule as between the packages."""
    on, without = analyses(PORT, "screens_on"), analyses(PORT, off)
    assert on["exceptions"] == without["exceptions"] == []
    assert [issue["swc-id"] for issue in on["json"]["issues"]] == ["106"]
    assert report_view(without["json"]) == report_view(on["json"])
    report_parity(without["json"], on["json"], without["pool"] == on["pool"])
    # test_cfa.py's and test_taint.py's A/B counters: a screen counts only
    # while it is on (the absint tables are built only while theirs is)
    def count(analysis, name):
        value = analysis["metrics"].get(name, 0)
        return value["count"] if isinstance(value, dict) else value

    counter = {"no_cfa": "cfa.screen.answered",
               "no_taint": "taint.screen.modules_skipped",
               "no_absint": "absint.build_ms"}[off]
    assert count(on, counter) > 0
    assert count(without, counter) == 0
