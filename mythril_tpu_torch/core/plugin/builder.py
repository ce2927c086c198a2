"""Plugin builders (API parity: mythril/laser/plugin/builder.py:6-20).

The port's copy of mythril_tpu/core/plugin/builder.py."""

from __future__ import annotations

from .interface import LaserPlugin


class PluginBuilder:
    name = "plugin-builder"

    def __init__(self):
        self.enabled = True

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        raise NotImplementedError
