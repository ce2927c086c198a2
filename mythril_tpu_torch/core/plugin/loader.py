"""Plugin loader / instrumentation bus (API parity: mythril/laser/plugin/loader.py:12-77).

The port's copy of mythril_tpu/core/plugin/loader.py."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from .builder import PluginBuilder
from .interface import LaserPlugin

log = logging.getLogger(__name__)


class LaserPluginLoader:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.laser_plugin_builders = {}
            cls._instance.plugin_args = {}
            cls._instance.plugin_list = {}
        return cls._instance

    def load(self, plugin_builder: PluginBuilder) -> None:
        if plugin_builder.name in self.laser_plugin_builders:
            log.warning("plugin %s already loaded", plugin_builder.name)
            return
        self.laser_plugin_builders[plugin_builder.name] = plugin_builder

    def is_enabled(self, plugin_name: str) -> bool:
        builder = self.laser_plugin_builders.get(plugin_name)
        return builder is not None and builder.enabled

    def enable(self, plugin_name: str) -> None:
        if plugin_name in self.laser_plugin_builders:
            self.laser_plugin_builders[plugin_name].enabled = True

    def disable(self, plugin_name: str) -> None:
        if plugin_name in self.laser_plugin_builders:
            self.laser_plugin_builders[plugin_name].enabled = False

    def add_args(self, plugin_name: str, **kwargs) -> None:
        self.plugin_args[plugin_name] = kwargs

    def instrument_virtual_machine(self, symbolic_vm, with_plugins: Optional[List[str]] = None):
        for name, builder in self.laser_plugin_builders.items():
            if not builder.enabled:
                continue
            if with_plugins is not None and name not in with_plugins:
                continue
            plugin = builder(**self.plugin_args.get(name, {}))
            plugin.initialize(symbolic_vm)
            self.plugin_list[name] = plugin
            log.debug("instrumented plugin %s", name)

    def reset(self) -> None:
        self.laser_plugin_builders = {}
        self.plugin_args = {}
        self.plugin_list = {}
