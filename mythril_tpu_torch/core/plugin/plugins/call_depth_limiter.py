"""Call depth limiter (capability parity:
mythril/laser/plugin/plugins/call_depth_limiter.py:16).

The port's copy of mythril_tpu/core/plugin/plugins/call_depth_limiter.py."""

from __future__ import annotations

from ...state.global_state import GlobalState
from ..builder import PluginBuilder
from ..interface import LaserPlugin
from ..signals import PluginSkipState


class CallDepthLimit(LaserPlugin):
    def __init__(self, call_depth_limit: int = 3):
        self.call_depth_limit = call_depth_limit

    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.instr_hook("pre", "CALL")
        def call_check(global_state: GlobalState):
            if len(global_state.transaction_stack) - 1 >= self.call_depth_limit:
                raise PluginSkipState


class CallDepthLimitBuilder(PluginBuilder):
    name = "call-depth-limit"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return CallDepthLimit(kwargs.get("call_depth_limit", 3))
