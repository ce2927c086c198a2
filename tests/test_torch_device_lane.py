"""The analyzer on the port's device SAT lane (`--solver jax`: the solver's
queries through smt/solver/dispatch.py onto parallel/device_solver.py,
here its plain twin of K11, `dispatch.configure(device="cpu")`) against
the JAX package, on the CPU.

- tests/test_resilience.py's `test_inject_device_oom_analysis_completes_
  via_host_ladder` on both packages: an injected device OOM under
  `--solver jax` is classified once, the breaker stays CLOSED and the CDCL
  ladder finds the same issue, the device stubbed as the reference stubs
  it.
- A solver call inside an instruction under `--solver jax`: the symbolic
  calldata slice (core/state/calldata.py), from an `execute_state` hook of
  the laser, decided on the twin; the same slice and statespace as the
  host CDCL and the JAX package, nothing dropped by the exec loop's catch
  of NotImplementedError.
- `analyze --engine tpu --solver jax` end to end on the tx.origin contract,
  the port on its twins at 16 lanes with a device clause cap of 4096 (the
  JAX package's CPU gates shrink MYTHRIL_TPU_DEVICE_CLAUSE_CAP the same
  way: this contract's queries, 20-25 thousand clauses, go through the
  dispatch and are answered by the CDCL; the twin takes seconds a step at
  that size on a CPU), held by `report_parity` to the JAX CLI's report with
  its default solver — the solver changes no verdict. The slow case
  recomputes that premise: the JAX CLI's report under `--solver jax`
  (about 200 s of solver on a CPU) against its report with the CDCL.
- Without a card, `analyze --solver jax` exits 2 naming the CUDA device."""

import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_engine import (BUDGET_S, JAX, PORT, analyze_report,
                           report_parity, report_view, run_on)
from chip_smoke import KILLBILLY, TX_ORIGIN
from mythril_tpu.parallel import jax_solver
from mythril_tpu.support import resilience as jresilience
from mythril_tpu_torch.parallel import device_solver
from mythril_tpu_torch.parallel import frontier as pf
from mythril_tpu_torch.smt.solver import dispatch as pdispatch
from mythril_tpu_torch.support import resilience as presilience

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
LANE = {"jax": jax_solver, "port": device_solver}
RESILIENCE = {"jax": jresilience, "port": presilience}


@pytest.fixture(autouse=True)
def _port_lane_on_the_cpu():
    """The port's SAT lane and frontier on their twins, on one torch
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pdispatch.configure(device="cpu")
    try:
        yield
    finally:
        pdispatch.reset_settings()
        pf.reset()
        torch.set_num_threads(threads)


def killbilly_analysis(side, modules):
    """tests/test_resilience.py's `_analyze(2, modules)`."""
    from importlib import import_module

    package = "mythril_tpu" if side is JAX else "mythril_tpu_torch"
    security = import_module(package + ".analysis.security")
    symbolic = import_module(package + ".analysis.symbolic")
    security.reset_callback_modules()
    creation = side.asm.creation_wrapper(
        side.asm.assemble(side.asm.dispatcher(KILLBILLY)))
    wrapper = symbolic.SymExecWrapper(
        creation.hex(), address=None, strategy="bfs", max_depth=128,
        execution_timeout=240, create_timeout=30, transaction_count=2,
        modules=modules, compulsory_statespace=False)
    return security.fire_lasers(wrapper, white_list=modules)


def injected_oom(side, patch):
    """An injected device OOM at the first flush, then a device that
    answers UNKNOWN (never a device solve): the CDCL ladder decides."""
    lane = LANE[side.name]
    patch.setattr(lane, "solve_cnf_device",
                  lambda clauses, n_vars, **kw: (lane.UNKNOWN, None))
    patch.setattr(lane, "solve_cnf_device_batch",
                  lambda queries, **kw: [(lane.UNKNOWN, None)
                                         for _ in queries])
    modules = ["AccidentallyKillable"]
    baseline = killbilly_analysis(side, modules)
    resilience = RESILIENCE[side.name]
    side.stats().reset()
    resilience.reset()
    side.args.solver = "jax"
    resilience.configure("device_oom:1")
    injected = killbilly_analysis(side, modules)
    stats = side.stats()
    health = resilience.registry.backend(resilience.DEVICE)
    out = [[issue.swc_id for issue in baseline],
           [issue.swc_id for issue in injected],
           injected[0].transaction_sequence["steps"][-1]["input"][:10],
           baseline[0].transaction_sequence["steps"][-1]["input"][:10],
           dict(stats.failure_counts), health.state, stats.breaker_trips,
           stats.device_queries > 0]
    resilience.configure(None)
    return out


def test_inject_device_oom_analysis_completes_via_host_ladder():
    with pytest.MonkeyPatch.context() as patch:
        jax = run_on(JAX, injected_oom, patch)
    with pytest.MonkeyPatch.context() as patch:
        port = run_on(PORT, injected_oom, patch)
    assert port == jax
    assert port[:2] == [["106"], ["106"]] and port[2] == port[3]
    assert port[4:] == [{"device:device_oom": 1}, "closed", 0, True]


#: CALLDATALOAD of the selector, then STOP: the slice runs at its load
SLICE_CODE = "600035" "00"


def slice_in_an_instruction(side, solver):
    """The symbolic calldata slice [0, stop), stop the two low bits of
    CALLDATASIZE, from the laser's `execute_state` hook at the CALLDATALOAD:
    its length, the statespace and the device lane's tallies."""
    side.args.solver = solver
    laser = side.svm.LaserEVM(max_depth=128, execution_timeout=BUDGET_S,
                              create_timeout=BUDGET_S, transaction_count=1,
                              requires_statespace=False)
    lengths = []

    def hook(state):
        if state.get_current_instruction()["opcode"] != "CALLDATALOAD":
            return
        calldata = state.environment.calldata
        size = calldata.calldatasize
        stop = side.smt.Concat(side.smt.symbol_factory.BitVecVal(0, 254),
                               side.smt.Extract(1, 0, size))
        lengths.append(len(calldata[0:stop]))

    laser.register_laser_hooks("execute_state", hook)
    world_state = side.state.WorldState()
    account = world_state.create_account(balance=0, address=None,
                                         concrete_storage=True)
    account.code = side.Disassembly(SLICE_CODE)
    laser.sym_exec(world_state=world_state,
                   target_address=account.address.value)
    stats = side.stats()
    return {"lengths": lengths, "states": laser.total_states,
            "open": len(laser.open_states),
            "device": [stats.device_queries, stats.device_fallbacks]}


def test_solver_call_inside_an_instruction_runs_on_the_lane():
    """Under `--solver jax` the slice's solver calls reach the port's twin
    and decide as the CDCL does: the same slice, the same states, on the
    JAX package too (its lane stubbed with its CDCL); before this lane was
    ported the call raised NotImplementedError, which the exec loop's
    catch turned into a silently dropped state."""
    port_cdcl = run_on(PORT, slice_in_an_instruction, "cdcl")
    port_jax = run_on(PORT, slice_in_an_instruction, "jax")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_solver, "solve_cnf_device",
                      lambda clauses, n_vars, **kw: JAX.solver.sat.solve_cnf(
                          clauses, n_vars))
        jax_jax = run_on(JAX, slice_in_an_instruction, "jax")
    assert port_jax["lengths"] == port_cdcl["lengths"] == \
        jax_jax["lengths"] == [3]
    assert (port_jax["states"], port_jax["open"]) == \
        (port_cdcl["states"], port_cdcl["open"]) == \
        (jax_jax["states"], jax_jax["open"])
    queries, fallbacks = port_jax["device"]
    assert queries > 0 and fallbacks == 0
    assert port_cdcl["device"] == [0, 0]


#: the device clause cap of the end-to-end case (the JAX package's CPU
#: gates set MYTHRIL_TPU_DEVICE_CLAUSE_CAP alike)
E2E_CLAUSE_CAP = 4096
E2E_LANES = 16


def tx_origin_report(side, **options):
    code = side.asm.creation_wrapper(
        side.asm.assemble(side.asm.dispatcher(TX_ORIGIN)))
    report = analyze_report(side, code, ["TxOrigin"], 1, **options)
    stats = side.stats()
    report["device"] = [stats.device_queries, stats.device_fallbacks,
                        stats.batch_submitted, stats.batch_flushes]
    return report


def test_analyze_engine_tpu_solver_jax_tx_origin():
    """The port's `analyze --engine tpu --solver jax` (twins, 16 lanes,
    the device clause cap at 4096) gives the JAX CLI's report with its
    default solver, by `report_parity`; every query it asked went through
    the dispatch, and the ones over the cap fell to the CDCL."""
    pf.configure(lanes=E2E_LANES, device="cpu")
    pdispatch.configure(device="cpu", clause_cap=E2E_CLAUSE_CAP)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MYTHRIL_TPU_LANES", str(E2E_LANES))
        jax = run_on(JAX, lambda side: tx_origin_report(side, engine="tpu"))
    port = run_on(PORT, lambda side: tx_origin_report(side, engine="tpu",
                                                      solver="jax"))
    assert port["exceptions"] == jax["exceptions"] == []
    report_parity(port["json"], jax["json"], same_pool=False)
    assert [issue["swc-id"] for issue in port["json"]["issues"]] == ["115"]
    queries, fallbacks, submitted, flushes = port["device"]
    assert queries > 0 and fallbacks == queries and flushes > 0
    assert submitted >= queries
    assert jax["device"][0] == 0


@pytest.mark.slow
def test_jax_cli_solver_jax_gives_the_cdcl_report(tmp_path):
    """The premise of the end-to-end case: the JAX CLI's report under
    `--solver jax` is its report with the CDCL (report_view; the witness
    replayed). Its device lane runs XLA's DPLL on the CPU, about 200 s of
    solver for this contract. Recompute with

        MYTHRIL_TPU_LANES=16 python -m mythril_tpu analyze -c <TX_ORIGIN
        creation hex> -t 1 -m TxOrigin -o json --engine tpu --solver jax

    against the same command without `--solver jax`, HOME a fresh
    directory (the JAX signature database lives there)."""
    code = PORT.asm.creation_wrapper(
        PORT.asm.assemble(PORT.asm.dispatcher(TX_ORIGIN))).hex()
    argv = ["analyze", "-c", code, "-t", "1", "-m", "TxOrigin", "-o", "json",
            "--engine", "tpu"]
    env = dict(os.environ, HOME=str(tmp_path), MYTHRIL_TPU_LANES="16",
               PYTHONPATH=REPO)
    reports = []
    for extra in ([], ["--solver", "jax"]):
        proc = subprocess.run([sys.executable, "-m", "mythril_tpu", *argv,
                               *extra], capture_output=True, text=True,
                              cwd=str(tmp_path), env=env, timeout=1800)
        assert proc.returncode == 1, proc.stderr[-2000:]
        reports.append(json.loads(proc.stdout))
    assert report_view(reports[1]) == report_view(reports[0])
    report_parity(reports[1], reports[0], same_pool=False)


def test_solver_jax_without_a_card_refuses(tmp_path):
    """`--solver jax` decides on the CUDA card: without one the CLI exits
    2 with `device.resolve`'s error, naming the CUDA device, before any
    contract is analyzed, never on the host or the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --solver jax runs on it")
    code = PORT.asm.creation_wrapper(
        PORT.asm.assemble(PORT.asm.dispatcher(TX_ORIGIN))).hex()
    proc = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-c", code,
         "-t", "1", "-o", "json", "--solver", "jax"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env=dict(os.environ, HOME=str(tmp_path), PYTHONPATH=REPO))
    assert proc.returncode == 2, (proc.stdout, proc.stderr)
    assert "CUDA device" in proc.stderr and proc.stdout == ""
    assert os.listdir(tmp_path) == []


#: tests/test_torch_tpu_engine.py's contradiction: the device forks both
#: sides of a second check of the calldata word, escape-time pruning finds
#: one infeasible
CONTRADICTION = {
    "pick()": "PUSH1 0x04\nCALLDATALOAD\nPUSH1 0x05\nEQ\nPUSH @five\n"
              "JUMPI\nSTOP\nfive:\nJUMPDEST\nPUSH1 0x04\nCALLDATALOAD\n"
              "PUSH1 0x06\nEQ\nPUSH @six\nJUMPI\nSTOP\nsix:\nJUMPDEST\n"
              "CALLER\nSELFDESTRUCT",
}


def pruned_statespace(side, solver, pending):
    """`LaserEVM(engine="tpu")` on CONTRADICTION, one transaction, with
    escape-time pruning; `pending` gets the dispatch's queue length at each
    `_feasible`."""
    from mythril_tpu_torch.smt.solver import dispatch

    side.args.solver = solver
    feasible = pf.Frontier._feasible

    def recorded(self, *args):
        pending.append(dispatch.pending_count())
        return feasible(self, *args)

    runtime = side.asm.assemble(side.asm.dispatcher(CONTRADICTION))
    laser = side.svm.LaserEVM(max_depth=128, execution_timeout=BUDGET_S,
                              create_timeout=BUDGET_S, transaction_count=1,
                              engine="tpu")
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(pf.Frontier, "_feasible", recorded)
        laser.sym_exec(creation_code=side.asm.creation_wrapper(
            runtime).hex(), contract_name="pick")
    stats = side.stats()
    return {"states": laser.total_states, "open": len(laser.open_states),
            "device": stats.device_queries, "flushes": stats.batch_flushes}


def test_escape_pruning_slab_queues_device_queries():
    """With escape-time pruning under `--solver jax` the driver's slab
    (`_prefetch_feasibility` -> `prefetch_models`) queues the rows'
    feasibility queries on the dispatch before the first `_feasible`
    demands one, so they flush as one batch; the pruning is the CDCL's."""
    pf.configure(lanes=E2E_LANES, device="cpu", check_escapes=True)
    pdispatch.configure(device="cpu", clause_cap=E2E_CLAUSE_CAP)
    device_pending, host_pending = [], []
    on_device = run_on(PORT, pruned_statespace, "jax", device_pending)
    on_host = run_on(PORT, pruned_statespace, "cdcl", host_pending)
    assert device_pending and device_pending[0] > 0
    assert set(host_pending) == {0}
    assert (on_device["states"], on_device["open"]) == \
        (on_host["states"], on_host["open"])
    assert on_device["device"] > 0 and on_device["flushes"] > 0
    assert on_host["device"] == 0
