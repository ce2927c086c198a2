"""Coverage metrics time-series for report extras (capability parity:
mythril/laser/plugin/plugins/coverage_metrics/metrics_plugin.py:41).

The port's copy of mythril_tpu/core/plugin/plugins/coverage_metrics.py."""

from __future__ import annotations

import time
from typing import Dict, List

from ...execution_info import ExecutionInfo
from ...state.global_state import GlobalState
from ..builder import PluginBuilder
from ..interface import LaserPlugin


class CoverageMetrics(ExecutionInfo):
    def __init__(self):
        self.instruction_coverage_per_code: Dict[str, float] = {}
        self.branch_coverage_per_code: Dict[str, float] = {}
        self.time_series: List[Dict] = []

    def as_dict(self):
        return {
            "instruction_coverage": self.instruction_coverage_per_code,
            "branch_coverage": self.branch_coverage_per_code,
            "coverage_time_series": self.time_series,
        }


class CoverageMetricsPlugin(LaserPlugin):
    def __init__(self):
        self.metrics = CoverageMetrics()
        self._covered: Dict[str, set] = {}
        self._branches: Dict[str, set] = {}
        self._covered_branches: Dict[str, set] = {}
        self._start = None
        self._last_sample = 0.0

    def initialize(self, symbolic_vm) -> None:
        self._start = time.time()

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(global_state: GlobalState):
            code = global_state.environment.code.bytecode
            instruction = global_state.get_current_instruction()
            self._covered.setdefault(code, set()).add(instruction["address"])
            if code not in self._branches:
                branch_addresses = {
                    ins.address
                    for ins in global_state.environment.code.instruction_list
                    if ins.op_code == "JUMPI"}
                self._branches[code] = branch_addresses
            if instruction["opcode"] == "JUMPI":
                self._covered_branches.setdefault(code, set()).add(
                    instruction["address"])
            now = time.time()
            if now - self._last_sample > 1.0:
                self._last_sample = now
                self._sample(code, now)

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_hook():
            for code in self._covered:
                self._finalize(code)

    def _instruction_coverage(self, code: str) -> float:
        total = max(1, len(code) // 2)
        return min(100.0, len(self._covered.get(code, ())) / total * 100)

    def _branch_coverage(self, code: str) -> float:
        total = len(self._branches.get(code, ()))
        if total == 0:
            return 100.0
        return len(self._covered_branches.get(code, ())) / total * 100

    def _sample(self, code: str, now: float) -> None:
        self.metrics.time_series.append({
            "time_elapsed": now - self._start,
            "instruction_coverage": self._instruction_coverage(code),
            "branch_coverage": self._branch_coverage(code),
        })

    def _finalize(self, code: str) -> None:
        self.metrics.instruction_coverage_per_code[code] = \
            self._instruction_coverage(code)
        self.metrics.branch_coverage_per_code[code] = self._branch_coverage(code)


class CoverageMetricsPluginBuilder(PluginBuilder):
    name = "coverage-metrics"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return CoverageMetricsPlugin()
