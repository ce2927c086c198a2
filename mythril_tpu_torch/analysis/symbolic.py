"""SymExecWrapper: configure and run one full analysis (API parity:
mythril/analysis/symbolic.py:44 — strategy selection, plugin wiring, detector hook
installation, sym_exec run, post-hoc Call extraction from the statespace).

The port's copy of mythril_tpu/analysis/symbolic.py, without the fleet
member's hook (`fleet=`, the fleet driver's, ROADMAP A 11)."""

from __future__ import annotations

import copy
import logging
from typing import Dict, List, Optional, Union

from ..core.plugin import LaserPluginLoader
from ..core.plugin.plugins import (BenchmarkPluginBuilder, CallDepthLimitBuilder,
                                   CoverageMetricsPluginBuilder,
                                   CoveragePluginBuilder, DependencyPrunerBuilder,
                                   StateMergePluginBuilder,
                                   InstructionProfilerBuilder,
                                   MutationPrunerBuilder)
from ..core.strategy import (BasicSearchStrategy, BeamSearch,
                             BoundedLoopsStrategy, BreadthFirstSearchStrategy,
                             DelayConstraintStrategy, DepthFirstSearchStrategy,
                             ReturnRandomNaivelyStrategy,
                             ReturnWeightedRandomStrategy)
from ..core.svm import LaserEVM
from ..core.state.world_state import WorldState
from ..core.transaction.transaction_models import tx_id_manager
from ..smt import BitVec, symbol_factory
from ..support.support_args import args
from . import module_screen
from .module import ModuleLoader, get_detection_module_hooks
from .module.base import EntryPoint
from .ops import Call, VarType, get_variable
from .potential_issues import check_potential_issues

log = logging.getLogger(__name__)


class SymExecWrapper:
    def __init__(self, contract, address: Optional[Union[int, str, BitVec]],
                 strategy: str = "dfs", dynloader=None, max_depth: int = 22,
                 execution_timeout: Optional[int] = None,
                 loop_bound: int = 3, create_timeout: Optional[int] = None,
                 transaction_count: int = 2, modules: Optional[List[str]] = None,
                 compulsory_statespace: bool = True,
                 disable_dependency_pruning: bool = False,
                 run_analysis_modules: bool = True, enable_coverage_strategy: bool = False,
                 custom_modules_directory: str = "", engine: str = "host",
                 checkpoint_path: Optional[str] = None,
                 resume_path: Optional[str] = None):
        if isinstance(address, str):
            address = symbol_factory.BitVecVal(int(address, 16), 256)
        elif isinstance(address, int):
            address = symbol_factory.BitVecVal(address, 256)

        strategy_class = {
            "dfs": DepthFirstSearchStrategy,
            "bfs": BreadthFirstSearchStrategy,
            "naive-random": ReturnRandomNaivelyStrategy,
            "weighted-random": ReturnWeightedRandomStrategy,
            "beam-search": BeamSearch,
            "pending": DelayConstraintStrategy,
        }.get(strategy)
        if strategy_class is None:
            raise ValueError(f"invalid search strategy: {strategy}")

        requires_statespace = compulsory_statespace or \
            len(ModuleLoader().get_detection_modules(
                EntryPoint.POST, modules)) > 0
        self.modules = modules
        tx_id_manager.restart_counter()
        # a fresh analysis must not inherit another's keccak axioms: with
        # restarted tx ids, symbol names recur and stale concrete-hash
        # conditions would conflict with this run's (making everything
        # unsat)
        from ..core.function_managers import keccak_function_manager

        keccak_function_manager.reset()

        # non-incremental exploration: the RF prioritizer predicts which
        # function sequence to explore (reference symbolic.py:107-110)
        tx_strategy = None
        if not args.incremental_txs:
            from ..core.tx_prioritiser import RfTxPrioritiser

            tx_strategy = RfTxPrioritiser(contract)

        self.laser = LaserEVM(
            dynamic_loader=dynloader,
            max_depth=max_depth,
            execution_timeout=execution_timeout,
            create_timeout=create_timeout,
            strategy=strategy_class,
            transaction_count=transaction_count,
            requires_statespace=requires_statespace,
            tx_strategy=tx_strategy,
            engine=engine,
            checkpoint_path=checkpoint_path,
            resume_path=resume_path,
        )
        if loop_bound is not None:
            self.laser.extend_strategy(BoundedLoopsStrategy,
                                       loop_bound=loop_bound)

        plugin_loader = LaserPluginLoader()
        plugin_loader.reset()
        plugin_loader.load(CoverageMetricsPluginBuilder())
        plugin_loader.load(CoveragePluginBuilder())
        if not args.disable_mutation_pruner:
            plugin_loader.load(MutationPrunerBuilder())
        if not args.disable_iprof:
            plugin_loader.load(InstructionProfilerBuilder())
        plugin_loader.load(CallDepthLimitBuilder())
        plugin_loader.add_args("call-depth-limit",
                               call_depth_limit=args.call_depth_limit)
        if not disable_dependency_pruning:
            plugin_loader.load(DependencyPrunerBuilder())
        if args.enable_state_merging:
            plugin_loader.load(StateMergePluginBuilder())
        # issue emission is deferred to summary validation only while the
        # summary plugin is active (it must not leak into later analyses in
        # the same process)
        args.use_issue_annotations = args.enable_summaries
        if args.enable_summaries:
            from ..core.plugin.plugins.summary import SummaryPluginBuilder

            plugin_loader.load(SummaryPluginBuilder())
        plugin_loader.instrument_virtual_machine(self.laser, None)

        self.plugin_loader = plugin_loader

        # runtime-code analysis builds its world state up front: the taint
        # module screen needs the contract's disassembly before hooks are
        # registered
        creation_mode = isinstance(contract, str) or (
            hasattr(contract, "creation_code") and contract.creation_code
            and getattr(contract, "name", None))
        world_state = account = None
        if not creation_mode:
            world_state = WorldState()
            account = world_state.create_account(
                balance=10 ** 18,
                address=address.value if address is not None else None,
                concrete_storage=False, dynamic_loader=dynloader)
            if hasattr(contract, "disassembly"):
                account.code = contract.disassembly
            else:
                from ..frontends.disassembler import Disassembly

                account.code = Disassembly(
                    contract.code if hasattr(contract, "code") else contract)
            account.contract_name = getattr(contract, "name", "Unknown")

        if run_analysis_modules:
            analysis_modules = ModuleLoader().get_detection_modules(
                EntryPoint.CALLBACK, white_list=modules)
            if account is not None and dynloader is None:
                # creation transactions and dynamically loaded code run
                # hooks over bytecode the summary never saw, so the
                # whole-module screen only applies to pure runtime runs
                analysis_modules, skipped = module_screen.screen_modules(
                    analysis_modules, account.code)
                if skipped:
                    log.info(
                        "module screen: %d module(s) skipped — no "
                        "reachable hook opcode: %s", len(skipped),
                        ", ".join(type(m).__name__ for m in skipped))
            self.laser.register_hooks(
                hook_type="pre",
                hook_dict=get_detection_module_hooks(analysis_modules,
                                                     hook_type="pre"))
            self.laser.register_hooks(
                hook_type="post",
                hook_dict=get_detection_module_hooks(analysis_modules,
                                                     hook_type="post"))

            # two-phase PotentialIssue resolution at every transaction end
            @self.laser.laser_hook("transaction_end")
            def transaction_end_hook(global_state, transaction,
                                     return_global_state, revert):
                if return_global_state is None and not revert:
                    check_potential_issues(global_state)

        self.address = address
        if isinstance(contract, str):
            # raw creation bytecode
            self.laser.sym_exec(creation_code=contract, contract_name="Unknown")
        elif hasattr(contract, "creation_code") and contract.creation_code and \
                getattr(contract, "name", None):
            self.laser.sym_exec(creation_code=contract.creation_code,
                                contract_name=contract.name)
        else:
            # runtime-code analysis on the world state prepared above
            self.laser.sym_exec(world_state=world_state,
                                target_address=account.address.value)

        # statespace bookkeeping for POST modules / graph export
        self.nodes = self.laser.nodes
        self.edges = self.laser.edges
        if requires_statespace:
            self.calls = self._extract_calls()
        else:
            self.calls = []

    def _extract_calls(self) -> List[Call]:
        """Post-hoc Call extraction (reference symbolic.py:250-330)."""
        calls: List[Call] = []
        for node_id, node in self.nodes.items():
            for state in node.states:
                instruction = state.get_current_instruction()
                op = instruction["opcode"]
                if op not in ("CALL", "CALLCODE", "DELEGATECALL", "STATICCALL"):
                    continue
                stack = state.mstate.stack
                if len(stack) < 7:
                    continue
                if op in ("CALL", "CALLCODE"):
                    gas, to, value = (get_variable(stack[-1]),
                                      get_variable(stack[-2]),
                                      get_variable(stack[-3]))
                    calls.append(Call(node, state, None, op, to, gas, value))
                else:
                    gas, to = get_variable(stack[-1]), get_variable(stack[-2])
                    calls.append(Call(node, state, None, op, to, gas))
        return calls
