"""MythrilAnalyzer: run the symbolic engine + detectors and build the Report
(capability parity: mythril/mythril/mythril_analyzer.py:29 — fire_lasers:133,
graph_html, dump_statespace; argparse values snapshot into the Args singleton
exactly once here, mirroring the reference's flow :66-85).

The port's copy of mythril_tpu/mythril/mythril_analyzer.py. `fire_lasers` turns
an exception inside a contract's analysis into a traceback in the report,
so what cannot run raises here, in the constructor, before any contract
is analyzed: `engine="tpu"` without the device that
`parallel/frontier.configure` names, and `solver="jax"` without the one
`smt/solver/dispatch.configure` names (the CUDA card unless a test names
the CPU): `device.DeviceUnavailable`, never an analysis on the host or the
CPU in its place. The checkpoint and resume paths reach each contract's
LaserEVM (support/checkpoint.py) as in the JAX package; a fleet member's
are the paths with its contract id appended. `fleet` with `engine="tpu"`
and two or more contracts analyzes them as one fleet
(`parallel/fleet.py`); otherwise it logs and runs them one by one.
`metrics_out` and `trace_out` come from the CLI only (the JAX package
also reads MYTHRIL_TPU_METRICS and MYTHRIL_TPU_TRACE): a trace path
enables the span tracer with a run manifest, and at the end of
`fire_lasers` the trace is exported and the registry's snapshot written
(tmp + fsync + rename). Each
contract's explored states are logged beside its solver statistics
(INFO), where chip_smoke.py's `analyze` phase reads them, and a fleet's
driver counters as one JSON object (`fleet counters: {...}`), where its
`analyze_fleet` phase reads them."""

from __future__ import annotations

import json
import logging
import traceback
from typing import List, Optional

from ..analysis.report import Issue, Report
from ..analysis.security import fire_lasers, retrieve_callback_issues
from ..analysis.symbolic import SymExecWrapper
from ..observe import trace
from ..smt.solver.solver_statistics import SolverStatistics
from ..support.support_args import args
from ..support.loader import DynLoader

log = logging.getLogger(__name__)


class MythrilAnalyzer:
    def __init__(self, disassembler, cmd_args=None, strategy: str = "bfs",
                 address: Optional[str] = None):
        self.eth = disassembler.eth
        self.contracts = disassembler.contracts or []
        self.enable_online_lookup = disassembler.enable_online_lookup
        self.strategy = strategy
        self.address = address

        cmd = cmd_args or _Namespace()
        # on-chain fault-in defaults ON (reference parity); --no-onchain-data
        # disables it (ADVICE r2: the old default-True getattr disabled it
        # permanently because the CLI never defined the flag)
        self.use_onchain_data = not getattr(cmd, "no_onchain_data", False)
        self.execution_timeout = getattr(cmd, "execution_timeout", 600)
        self.loop_bound = getattr(cmd, "loop_bound", 3)
        self.create_timeout = getattr(cmd, "create_timeout", 10)
        self.max_depth = getattr(cmd, "max_depth", 128)
        self.engine = getattr(cmd, "engine", "host") or "host"
        self.fleet = getattr(cmd, "fleet", False)
        # an optional threading.Event that preempts every member of this
        # fleet run (the serve tier's QoS)
        self.fleet_preempt = getattr(cmd, "fleet_preempt", None)
        if self.engine == "tpu":
            from ..parallel import frontier

            frontier.resolve_device()
        if getattr(cmd, "solver", None) == "jax":
            from ..smt.solver import dispatch

            dispatch.resolve_device()
        self.checkpoint_path = getattr(cmd, "checkpoint", None)
        self.resume_path = getattr(cmd, "resume", None)
        self.disable_dependency_pruning = getattr(
            cmd, "disable_dependency_pruning", False)
        self.custom_modules_directory = getattr(
            cmd, "custom_modules_directory", "")
        # snapshot flags into the global Args singleton (reference :66-85)
        args.pruning_factor = getattr(cmd, "pruning_factor", None)
        args.solver_timeout = getattr(cmd, "solver_timeout", 10000)
        args.parallel_solving = getattr(cmd, "parallel_solving", False)
        args.unconstrained_storage = getattr(cmd, "unconstrained_storage",
                                             False)
        args.call_depth_limit = getattr(cmd, "call_depth_limit", 3)
        args.disable_iprof = getattr(cmd, "disable_iprof", True)
        args.solver_log = getattr(cmd, "solver_log", None)
        args.transaction_sequences = getattr(cmd, "transaction_sequences",
                                             None)
        args.incremental_txs = getattr(cmd, "incremental_txs", True)
        args.enable_state_merging = getattr(cmd, "enable_state_merging", False)
        args.enable_summaries = getattr(cmd, "enable_summaries", False)
        args.simplify = not getattr(cmd, "no_simplify", False)
        args.batch_solve = not getattr(cmd, "no_batch_solve", False)
        args.cfa = not getattr(cmd, "no_cfa", False)
        args.taint = not getattr(cmd, "no_taint", False)
        args.absint = not getattr(cmd, "no_absint", False)
        args.frontier_telemetry = not getattr(
            cmd, "no_frontier_telemetry", False)
        args.state_merge = not getattr(cmd, "no_state_merge", False)
        args.device_crosscheck = getattr(cmd, "device_crosscheck", 0)
        args.inject_fault = getattr(cmd, "inject_fault", None)
        solver = getattr(cmd, "solver", None)
        if solver:
            args.solver = solver
        # arm the deterministic fault plan (support/resilience.py) for this
        # analyzer — a no-op (disarmed plan) when --inject-fault is absent
        from ..support import resilience

        resilience.configure(args.inject_fault)
        # the metrics snapshot is written (fsync-atomic) at the end of
        # fire_lasers; the tracer records from here
        self.metrics_out = getattr(cmd, "metrics_out", None)
        trace_out = getattr(cmd, "trace_out", None)
        if trace_out:
            trace.enable(trace_out)
            trace.set_manifest(
                engine=self.engine, strategy=strategy,
                solver=getattr(args, "solver", "cdcl"),
                execution_timeout=self.execution_timeout,
                contracts=", ".join(c.name for c in self.contracts))

    def _dynloader(self):
        if self.use_onchain_data and self.eth is not None:
            return DynLoader(self.eth)
        return None

    # -- entry points ------------------------------------------------------------------
    def dump_statespace(self, contract=None, transaction_count: int = 2) -> str:
        from ..analysis.traceexplore import get_serializable_statespace
        import json

        contract = contract or self.contracts[0]
        sym = SymExecWrapper(
            contract, self.address, self.strategy,
            dynloader=self._dynloader(), max_depth=self.max_depth,
            execution_timeout=self.execution_timeout,
            transaction_count=transaction_count,
            create_timeout=self.create_timeout,
            disable_dependency_pruning=self.disable_dependency_pruning,
            run_analysis_modules=False)
        return json.dumps(get_serializable_statespace(sym))

    def graph_html(self, contract=None, transaction_count: int = 2,
                   enable_physics: bool = False) -> str:
        from ..analysis.callgraph import generate_graph

        contract = contract or self.contracts[0]
        sym = SymExecWrapper(
            contract, self.address, self.strategy,
            dynloader=self._dynloader(), max_depth=self.max_depth,
            execution_timeout=self.execution_timeout,
            transaction_count=transaction_count,
            create_timeout=self.create_timeout,
            disable_dependency_pruning=self.disable_dependency_pruning,
            run_analysis_modules=False)
        return generate_graph(sym, physics=enable_physics)

    def fire_lasers(self, modules: Optional[List[str]] = None,
                    transaction_count: int = 2) -> Report:
        """Run detection on every loaded contract (reference :133-200)."""
        all_issues: List[Issue] = []
        exceptions = []
        incomplete = False
        coverage: dict = {}
        if self.fleet and self.engine == "tpu" and len(self.contracts) >= 2:
            results = self.fleet_contract_results(modules, transaction_count)
            for entry in results:
                exceptions.extend(entry["exceptions"])
                if entry["timed_out"]:
                    incomplete = True
                    coverage = entry["coverage"]
                all_issues.extend(entry["issues"])
            return self._assemble_report(all_issues, exceptions, incomplete,
                                         coverage)
        if self.fleet:
            log.info("fleet mode needs engine=tpu and >= 2 contracts; "
                     "running sequentially")
        for contract in self.contracts:
            SolverStatistics().reset()
            sym = None
            contract_span = trace.span("analyze.contract",
                                       contract=contract.name)
            contract_span.__enter__()
            try:
                sym = SymExecWrapper(
                    contract,
                    self.address,
                    self.strategy,
                    dynloader=self._dynloader(),
                    max_depth=self.max_depth,
                    execution_timeout=self.execution_timeout,
                    loop_bound=self.loop_bound,
                    create_timeout=self.create_timeout,
                    transaction_count=transaction_count,
                    modules=modules,
                    compulsory_statespace=False,
                    disable_dependency_pruning=self.disable_dependency_pruning,
                    custom_modules_directory=self.custom_modules_directory,
                    engine=self.engine,
                    checkpoint_path=self.checkpoint_path,
                    resume_path=self.resume_path)
                issues = fire_lasers(sym, modules)
            except KeyboardInterrupt:
                log.critical("analysis interrupted, saving issues found so far")
                issues = retrieve_callback_issues(modules)
            except Exception:
                log.exception("exception during %s analysis", contract.name)
                exceptions.append(traceback.format_exc())
                issues = retrieve_callback_issues(modules)
            contract_span.__exit__(None, None, None)
            log.info("solver statistics: %s", SolverStatistics())
            laser = getattr(sym, "laser", None)
            if laser is not None:
                log.info("analysis of %s: %d states explored",
                         contract.name, laser.total_states)
            if laser is not None and getattr(laser, "timed_out", False):
                # deadline drain (core/svm.py): the report stays valid but
                # must say it is partial, with what-was-covered stats
                incomplete = True
                coverage = {
                    "executed_nodes": laser.executed_nodes,
                    "explored_states": laser.total_states,
                    "dropped_states": getattr(laser, "dropped_states", 0),
                    "open_states": len(laser.open_states),
                    "transactions_reached":
                        getattr(laser, "_current_tx_index", 0) + 1,
                }
                log.warning("analysis of %s is INCOMPLETE (deadline drain): "
                            "%s", contract.name, coverage)
            for issue in issues:
                issue.add_code_info(contract)
            all_issues.extend(issues)

        return self._assemble_report(all_issues, exceptions, incomplete,
                                     coverage)

    def _assemble_report(self, all_issues: List[Issue], exceptions,
                         incomplete: bool, coverage: dict) -> Report:
        source_data = [getattr(c, "input_file", c.name)
                       for c in self.contracts]
        report = Report(contracts=self.contracts, exceptions=exceptions)
        report.source = source_data
        report.incomplete = incomplete
        report.coverage = coverage
        for issue in all_issues:
            report.append_issue(issue)
        # flush the trace now (the atexit hook rewrites the final one; an
        # analyzer embedded in a longer process still leaves a loadable
        # file behind)
        trace.export()
        if self.metrics_out:
            from ..observe import metrics

            metrics.write_snapshot(self.metrics_out)
        return report

    # -- fleet mode --------------------------------------------------------------------

    def fleet_contract_results(self, modules: Optional[List[str]] = None,
                               transaction_count: int = 2) -> List[dict]:
        """Analyze every loaded contract as one fleet: one device frontier
        a transaction for all of them (parallel/fleet.py FleetDriver),
        while the swaps a turn keep each contract's detections a solo
        run's. One dict a contract, in contract order: ``{contract,
        contract_id, issues, exceptions, timed_out, coverage}``."""
        from ..parallel.fleet import FleetDriver, FleetMember

        contract_ids = _unique_contract_ids(self.contracts)
        SolverStatistics().reset()
        members: List[FleetMember] = []
        for index, (contract, cid) in enumerate(
                zip(self.contracts, contract_ids)):
            member = FleetMember(index, cid,
                                 execution_timeout=self.execution_timeout
                                 or 0, preempt=self.fleet_preempt)
            member.work = self._make_member_work(member, contract, modules,
                                                 transaction_count)
            members.append(member)
        driver = FleetDriver(members, modules=modules)
        log.info("fleet: packing %d contracts into one device frontier: %s",
                 len(members), ", ".join(contract_ids))
        with trace.span("analyze.fleet", contracts=len(members)):
            try:
                driver.run()
            except KeyboardInterrupt:
                log.critical(
                    "fleet analysis interrupted, saving issues found so far")
        log.info("solver statistics: %s", SolverStatistics())
        log.info("fleet counters: %s", json.dumps({
            **driver.counters(),
            "drained_by_member": {member.contract_id: member.drained
                                  for member in members}}, sort_keys=True))
        results = []
        for member, contract in zip(members, self.contracts):
            entry = {"contract": contract, "contract_id": member.contract_id,
                     "issues": [], "exceptions": [], "timed_out": False,
                     "coverage": {}}
            if member.traceback_str:
                entry["exceptions"].append(member.traceback_str)
            if member.result is not None:
                entry["issues"] = list(member.result)
            elif member.error is not None:
                # the work never reached its own harvest (a driver abort):
                # what the member's swapped-out snapshots hold
                for saved in member.module_state.values():
                    entry["issues"].extend(saved["issues"])
            laser = member.gate_laser or member.laser
            if laser is not None:
                log.info("analysis of %s: %d states explored",
                         member.contract_id, laser.total_states)
            if laser is not None and getattr(laser, "timed_out", False):
                entry["timed_out"] = True
                entry["coverage"] = {
                    "executed_nodes": laser.executed_nodes,
                    "explored_states": laser.total_states,
                    "dropped_states": getattr(laser, "dropped_states", 0),
                    "open_states": len(laser.open_states),
                    "transactions_reached":
                        getattr(laser, "_current_tx_index", 0) + 1,
                }
                log.warning("fleet analysis of %s is INCOMPLETE (deadline "
                            "drain): %s", member.contract_id,
                            entry["coverage"])
            for issue in entry["issues"]:
                issue.add_code_info(contract)
            results.append(entry)
        return results

    def _make_member_work(self, member, contract, modules,
                          transaction_count: int):
        """The member thread's body: a solo analysis of one contract whose
        device phases go through the fleet's gate
        (SymExecWrapper(fleet=member)), its checkpoint and resume paths
        suffixed with its contract id. Exceptions are handled here, on the
        member's turn under its own detector state, so the partial harvest
        is the sequential loop's."""
        checkpoint_path = resume_path = None
        if self.checkpoint_path:
            checkpoint_path = f"{self.checkpoint_path}.{member.contract_id}"
        if self.resume_path:
            resume_path = f"{self.resume_path}.{member.contract_id}"

        def work():
            try:
                sym = SymExecWrapper(
                    contract,
                    self.address,
                    self.strategy,
                    dynloader=self._dynloader(),
                    max_depth=self.max_depth,
                    execution_timeout=self.execution_timeout,
                    loop_bound=self.loop_bound,
                    create_timeout=self.create_timeout,
                    transaction_count=transaction_count,
                    modules=modules,
                    compulsory_statespace=False,
                    disable_dependency_pruning=self.disable_dependency_pruning,
                    custom_modules_directory=self.custom_modules_directory,
                    engine=self.engine,
                    checkpoint_path=checkpoint_path,
                    resume_path=resume_path,
                    fleet=member)
                return fire_lasers(sym, modules)
            except KeyboardInterrupt:
                log.critical("analysis of %s interrupted, saving issues "
                             "found so far", member.contract_id)
                return retrieve_callback_issues(modules)
            except Exception:
                log.exception("exception during %s fleet analysis",
                              member.contract_id)
                member.traceback_str = traceback.format_exc()
                member.error = RuntimeError(
                    f"fleet member {member.contract_id} failed")
                return retrieve_callback_issues(modules)

        return work


def _unique_contract_ids(contracts) -> List[str]:
    """Stable, file-name-safe and unique contract ids (checkpoint suffixes,
    occupancy slots, dispatch query origins)."""
    ids: List[str] = []
    seen: dict = {}
    for index, contract in enumerate(contracts):
        base = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                       for ch in (getattr(contract, "name", "") or ""))
        base = base or f"contract{index}"
        count = seen.get(base, 0)
        seen[base] = count + 1
        ids.append(base if count == 0 else f"{base}-{count + 1}")
    return ids


class _Namespace:
    pass
