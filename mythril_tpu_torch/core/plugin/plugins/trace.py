"""Trace finder: records (pc-address, tx-id) per executed state (capability parity:
mythril/laser/plugin/plugins/trace.py:24). Feeds concolic replay.

The port's copy of mythril_tpu/core/plugin/plugins/trace.py."""

from __future__ import annotations

from typing import List, Tuple

from ...state.global_state import GlobalState
from ..builder import PluginBuilder
from ..interface import LaserPlugin


class TraceFinder(LaserPlugin):
    def __init__(self):
        self.tx_trace: List[List[Tuple[int, str]]] = []

    def initialize(self, symbolic_vm) -> None:
        self.tx_trace = []

        @symbolic_vm.laser_hook("start_sym_trans")
        def start_sym_trans_hook():
            self.tx_trace.append([])

        @symbolic_vm.laser_hook("execute_state")
        def trace_jumps(global_state: GlobalState):
            if not self.tx_trace:
                self.tx_trace.append([])
            transaction = global_state.current_transaction
            self.tx_trace[-1].append(
                (global_state.get_current_instruction()["address"],
                 transaction.id if transaction else "0"))


class TraceFinderBuilder(PluginBuilder):
    name = "trace-finder"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return TraceFinder()
