"""Plugin control-flow signals (API parity: mythril/laser/plugin/signals.py:1-27).

The port's copy of mythril_tpu/core/plugin/signals.py."""

from ...exceptions import MythrilTpuBaseException


class PluginSignal(MythrilTpuBaseException):
    pass


class PluginSkipState(PluginSignal):
    """Raised by a plugin hook to drop the current state from exploration."""


class PluginSkipWorldState(PluginSignal):
    """Raised by a plugin hook to keep a post-tx world state out of open_states."""
