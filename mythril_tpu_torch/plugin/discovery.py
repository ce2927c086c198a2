"""Entry-point plugin discovery (capability parity:
mythril/plugin/discovery.py:8-21 PluginDiscovery).

Third-party packages publish detectors / engine plugins via the
`mythril_tpu_torch.plugins` entry-point group:

    [project.entry-points."mythril_tpu_torch.plugins"]
    my_detector = "my_package.module:MyDetector"

Discovery uses importlib.metadata (pkg_resources is deprecated).

The port's copy of mythril_tpu/plugin/discovery.py. Its group is the
port's own, not the reference's `mythril_tpu.plugins`: a plugin
published there subclasses the JAX package's classes and imports it,
and the port never loads the JAX package."""

from __future__ import annotations

import logging
from importlib.metadata import entry_points
from typing import Any, Dict, List, Optional

from .interface import MythrilPlugin

log = logging.getLogger(__name__)

ENTRY_POINT_GROUP = "mythril_tpu_torch.plugins"


class PluginDiscovery:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._installed_plugins = None
        return cls._instance

    def init_installed_plugins(self) -> None:
        found: Dict[str, Any] = {}
        try:
            group = entry_points(group=ENTRY_POINT_GROUP)
        except TypeError:  # Python < 3.10 signature
            group = entry_points().get(ENTRY_POINT_GROUP, [])
        for entry_point in group:
            try:
                found[entry_point.name] = entry_point.load()
            except Exception as error:
                log.warning("failed to load plugin entry point %s: %s",
                            entry_point.name, error)
        self._installed_plugins = found

    @property
    def installed_plugins(self) -> Dict[str, Any]:
        if self._installed_plugins is None:
            self.init_installed_plugins()
        return self._installed_plugins

    def is_installed(self, plugin_name: str) -> bool:
        return plugin_name in self.installed_plugins

    def build_plugin(self, plugin_name: str,
                     plugin_args: Optional[Dict] = None) -> MythrilPlugin:
        if not self.is_installed(plugin_name):
            raise ValueError(f"Plugin with name: `{plugin_name}` is not "
                             f"installed")
        plugin = self.installed_plugins.get(plugin_name)
        if plugin is None or not (isinstance(plugin, type)
                                  and issubclass(plugin, MythrilPlugin)):
            raise ValueError(f"No valid plugin was found for {plugin_name}")
        return plugin(**(plugin_args or {}))

    def get_plugins(self, default_enabled: Optional[bool] = None) -> List[str]:
        if default_enabled is None:
            return list(self.installed_plugins.keys())
        return [name for name, plugin_class in self.installed_plugins.items()
                if getattr(plugin_class, "plugin_default_enabled", False)
                == default_enabled]
