"""Per-opcode wall-time profiler (capability parity:
mythril/laser/plugin/plugins/instruction_profiler.py:41).

The engine is single-threaded and sequential, so one pending (opcode, start-time)
slot suffices: each execute_state settles the previous instruction's timing and
opens its own.

Timings land on the observe metrics registry (``profiler.instruction_us``,
one histogram label per opcode) instead of a private dict, so traceview and
run manifests see them; :attr:`records` derives the legacy
``opcode -> (min, max, total_seconds, count)`` mapping for existing callers.

The port's copy of mythril_tpu/core/plugin/plugins/instruction_profiler.py,
on the port's metric registry (`observe/metrics.py`)."""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

from ....observe import metrics
from ...state.global_state import GlobalState
from ..builder import PluginBuilder
from ..interface import LaserPlugin

log = logging.getLogger(__name__)


class InstructionProfiler(LaserPlugin):
    def __init__(self):
        metrics.reset("profiler.")  # a fresh profiler starts a fresh profile
        self._pending: Optional[Tuple[str, float]] = None

    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.laser_hook("execute_state")
        def tick(global_state: GlobalState):
            now = time.monotonic()
            self._settle(now)
            op = global_state.get_current_instruction()["opcode"]
            self._pending = (op, now)

        @symbolic_vm.laser_hook("stop_sym_exec")
        def print_results():
            self._settle(time.monotonic())
            if self.records:
                log.info("\n%s", self.report())

    def _settle(self, now: float) -> None:
        if self._pending is None:
            return
        op, started = self._pending
        self._pending = None
        metrics.observe("profiler.instruction_us", (now - started) * 1e6,
                        label=op)

    @property
    def records(self) -> Dict[str, Tuple[float, float, float, int]]:
        """opcode -> (min, max, total_seconds, count), derived from the
        ``profiler.instruction_us`` histogram labels (legacy shape)."""
        out: Dict[str, Tuple[float, float, float, int]] = {}
        for op in metrics.labels("profiler.instruction_us"):
            hist = metrics.histogram("profiler.instruction_us", op)
            out[op] = (hist.min / 1e6, hist.max / 1e6, hist.total / 1e6,
                       hist.count)
        return out

    def report(self) -> str:
        records = self.records
        lines = ["Instruction Perf Profile:"]
        total_time = sum(rec[2] for rec in records.values())
        for op, (minimum, maximum, total, count) in sorted(
                records.items(), key=lambda kv: -kv[1][2]):
            lines.append(
                f"  [{total / max(total_time, 1e-12) * 100:6.2f} %] {op}: "
                f"{count} calls, avg {total / count * 1e6:.1f}us, "
                f"min {minimum * 1e6:.1f}us, max {maximum * 1e6:.1f}us")
        return "\n".join(lines)


class InstructionProfilerBuilder(PluginBuilder):
    name = "instruction-profiler"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return InstructionProfiler()
