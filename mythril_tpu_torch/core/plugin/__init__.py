"""The port's copy of mythril_tpu/core/plugin/__init__.py."""

from .interface import LaserPlugin
from .builder import PluginBuilder
from .loader import LaserPluginLoader
from .signals import PluginSignal, PluginSkipState, PluginSkipWorldState

__all__ = ["LaserPlugin", "PluginBuilder", "LaserPluginLoader", "PluginSignal",
           "PluginSkipState", "PluginSkipWorldState"]
