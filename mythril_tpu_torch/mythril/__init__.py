"""Orchestration layer (capability parity: mythril/mythril/ —
MythrilDisassembler:43, MythrilAnalyzer:29, MythrilConfig:18).

The port's copy of mythril_tpu/mythril/__init__.py."""

from .mythril_analyzer import MythrilAnalyzer
from .mythril_config import MythrilConfig
from .mythril_disassembler import MythrilDisassembler

__all__ = ["MythrilAnalyzer", "MythrilConfig", "MythrilDisassembler"]
