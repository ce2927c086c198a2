"""Third-party plugin interfaces (capability parity:
mythril/plugin/interface.py — MythrilPlugin / MythrilLaserPlugin).

The port's copy of mythril_tpu/plugin/interface.py."""

from __future__ import annotations

from abc import ABC, abstractmethod


class MythrilPlugin:
    """Base class for discoverable plugins (detection modules subclass
    DetectionModule AND this marker; engine plugins use MythrilLaserPlugin).

    Packages expose plugins through the `mythril_tpu_torch.plugins`
    entry-point group; `PluginDiscovery` finds them and
    `MythrilPluginLoader` activates them."""

    author = "unknown"
    name = "plugin"
    plugin_license = "All rights reserved."
    plugin_type = "Mythril Plugin"
    plugin_version = "0.0.1"
    plugin_description = ""
    plugin_default_enabled = False

    def __repr__(self):
        return f"{self.plugin_type}: {self.name} v{self.plugin_version} " \
               f"({self.author})"


class MythrilLaserPlugin(MythrilPlugin, ABC):
    """Engine-instrumentation plugin: must build a LaserPlugin
    (core/plugin/interface.py) when called."""

    @abstractmethod
    def __call__(self, *args, **kwargs):
        """Build the LaserPlugin instance."""
