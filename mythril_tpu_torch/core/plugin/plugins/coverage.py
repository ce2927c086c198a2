"""Instruction coverage plugin + coverage-driven strategy (capability parity:
mythril/laser/plugin/plugins/coverage/coverage_plugin.py:20 + coverage_strategy.py:6).

The port's copy of mythril_tpu/core/plugin/plugins/coverage.py."""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from ...state.global_state import GlobalState
from ...strategy.basic import BasicSearchStrategy
from ..builder import PluginBuilder
from ..interface import LaserPlugin

log = logging.getLogger(__name__)


class InstructionCoveragePlugin(LaserPlugin):
    """Per-bytecode boolean vector of executed instruction indices."""

    def __init__(self):
        self.coverage: Dict[str, Tuple[int, List[bool]]] = {}
        self.initial_coverage = 0
        self.tx_id = 0

    def initialize(self, symbolic_vm) -> None:
        self.coverage = {}
        self.tx_id = 0

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(global_state: GlobalState):
            code = global_state.environment.code.bytecode
            if code not in self.coverage:
                number_of_instructions = len(
                    global_state.environment.code.instruction_list)
                self.coverage[code] = (number_of_instructions,
                                       [False] * number_of_instructions)
            count, vector = self.coverage[code]
            if global_state.mstate.pc < len(vector):
                vector[global_state.mstate.pc] = True

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_sym_exec_hook():
            for code, (total, vector) in self.coverage.items():
                if total == 0:
                    continue
                percentage = sum(vector) / total * 100
                log.info("achieved %.2f%% coverage for code: %s...",
                         percentage, code[:30])

    def get_coverage(self, code: str) -> float:
        if code not in self.coverage:
            return 0.0
        total, vector = self.coverage[code]
        return sum(vector) / total * 100 if total else 0.0


class CoverageStrategy(BasicSearchStrategy):
    """Prefers states at not-yet-covered instructions (reference
    coverage_strategy.py:6)."""

    def __init__(self, super_strategy: BasicSearchStrategy,
                 coverage_plugin: InstructionCoveragePlugin):
        self.super_strategy = super_strategy
        self.coverage_plugin = coverage_plugin
        super().__init__(super_strategy.work_list, super_strategy.max_depth)

    def get_strategic_global_state(self) -> GlobalState:
        for index, state in enumerate(self.work_list):
            if not self._is_covered(state):
                return self.work_list.pop(index)
        return self.super_strategy.get_strategic_global_state()

    def _is_covered(self, global_state: GlobalState) -> bool:
        code = global_state.environment.code.bytecode
        entry = self.coverage_plugin.coverage.get(code)
        if entry is None:
            return False
        _, vector = entry
        pc = global_state.mstate.pc
        return pc < len(vector) and vector[pc]


class CoveragePluginBuilder(PluginBuilder):
    name = "coverage"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return InstructionCoveragePlugin()
