"""Third-party plugin activation (capability parity:
mythril/plugin/loader.py:21 MythrilPluginLoader): dispatches discovered
plugins by kind — DetectionModule instances register with the analysis
ModuleLoader, MythrilLaserPlugin builders with the engine's
LaserPluginLoader.

The port's copy of mythril_tpu/plugin/loader.py."""

from __future__ import annotations

import logging
from typing import List

from ..analysis.module.base import DetectionModule
from ..analysis.module.loader import ModuleLoader
from ..core.plugin.builder import PluginBuilder
from ..core.plugin.loader import LaserPluginLoader
from .discovery import PluginDiscovery
from .interface import MythrilLaserPlugin, MythrilPlugin

log = logging.getLogger(__name__)


class UnsupportedPluginType(Exception):
    """Raised when a plugin of an unknown kind is loaded."""


class MythrilPluginLoader:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.loaded_plugins = []
            cls._instance.plugin_args = {}
            cls._instance._defaults_loaded = False
        return cls._instance

    def set_args(self, plugin_name: str, **kwargs) -> None:
        self.plugin_args[plugin_name] = kwargs

    def load(self, plugin: MythrilPlugin) -> None:
        if not isinstance(plugin, MythrilPlugin):
            raise ValueError("Passed plugin is not of type MythrilPlugin")
        log.info("loading plugin: %s", plugin)
        if isinstance(plugin, DetectionModule):
            self._load_detection_module(plugin)
        elif isinstance(plugin, MythrilLaserPlugin):
            self._load_laser_plugin(plugin)
        else:
            raise UnsupportedPluginType(
                f"Passed plugin type is not yet supported: {type(plugin)}")
        self.loaded_plugins.append(plugin)

    @staticmethod
    def _load_detection_module(plugin: DetectionModule) -> None:
        ModuleLoader().register_module(plugin)

    @staticmethod
    def _load_laser_plugin(plugin: MythrilLaserPlugin) -> None:
        class _Adapter(PluginBuilder):
            name = plugin.name

            def __call__(self, *args, **kwargs):
                return plugin(*args, **kwargs)

        LaserPluginLoader().load(_Adapter())

    def load_default_enabled(self) -> List[str]:
        """Discover and activate every installed default-enabled plugin."""
        if self._defaults_loaded:
            return []
        self._defaults_loaded = True
        loaded = []
        discovery = PluginDiscovery()
        for name in discovery.get_plugins(default_enabled=True):
            try:
                plugin = discovery.build_plugin(name,
                                                self.plugin_args.get(name))
                self.load(plugin)
                loaded.append(name)
            except Exception as error:
                log.warning("failed to activate plugin %s: %s", name, error)
        return loaded
