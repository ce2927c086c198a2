"""Discovery and activation of third-party plugins (capability parity:
mythril/plugin/).

The port's copy of mythril_tpu/plugin/, on its own entry-point group,
`mythril_tpu_torch.plugins` (discovery.ENTRY_POINT_GROUP)."""

from .discovery import PluginDiscovery
from .interface import MythrilPlugin, MythrilLaserPlugin
from .loader import MythrilPluginLoader, UnsupportedPluginType

__all__ = ["PluginDiscovery", "MythrilPlugin", "MythrilLaserPlugin",
           "MythrilPluginLoader", "UnsupportedPluginType"]
