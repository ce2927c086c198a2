"""The plugin layer's control-flow signals. The plugins themselves, their
interface, builder and loader come with ROADMAP A 6b.2b."""

from .signals import PluginSignal, PluginSkipState, PluginSkipWorldState

__all__ = ["PluginSignal", "PluginSkipState", "PluginSkipWorldState"]
