"""Benchmark plugin: states/sec + coverage over time (capability parity:
mythril/laser/plugin/plugins/benchmark.py:19 — without the matplotlib dependency;
emits a dict consumable by bench.py).

Counters live on the observe metrics registry (``bench.instructions``,
``bench.states_per_sec``) rather than private attributes, so the run report
and traces see the same numbers; :attr:`nr_of_executed_insns` stays as a
facade property for existing callers.

The port's copy of mythril_tpu/core/plugin/plugins/benchmark.py, on the
port's metric registry (`observe/metrics.py`)."""

from __future__ import annotations

import time
from typing import Dict

from ....observe import metrics
from ...state.global_state import GlobalState
from ..builder import PluginBuilder
from ..interface import LaserPlugin


class BenchmarkPlugin(LaserPlugin):
    def __init__(self, name: str = "benchmark"):
        metrics.reset("bench.")
        self.begin: float = 0.0
        self.end: float = 0.0
        self.points: Dict[float, int] = {}

    def initialize(self, symbolic_vm) -> None:
        metrics.reset("bench.")

        @symbolic_vm.laser_hook("start_sym_exec")
        def start_hook():
            self.begin = time.time()

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_hook():
            self.end = time.time()
            metrics.set_gauge("bench.states_per_sec", self.states_per_second)

        @symbolic_vm.laser_hook("execute_state")
        def execute_state_hook(_: GlobalState):
            metrics.inc("bench.instructions")
            self.points[round(time.time() - self.begin, 1)] = \
                self.nr_of_executed_insns

    @property
    def nr_of_executed_insns(self) -> int:
        return metrics.value("bench.instructions")

    @property
    def states_per_second(self) -> float:
        duration = (self.end or time.time()) - self.begin
        return self.nr_of_executed_insns / duration if duration > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "executed_instructions": self.nr_of_executed_insns,
            "duration": (self.end or time.time()) - self.begin,
            "states_per_second": self.states_per_second,
        }


class BenchmarkPluginBuilder(PluginBuilder):
    name = "benchmark"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return BenchmarkPlugin()
