"""Laser plugin interface (API parity: mythril/laser/plugin/interface.py:4-24).

The port's copy of mythril_tpu/core/plugin/interface.py."""

from __future__ import annotations


class LaserPlugin:
    def initialize(self, symbolic_vm) -> None:
        """Install hooks on the virtual machine."""
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__
