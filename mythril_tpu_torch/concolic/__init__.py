"""Concolic mode: concrete trace recording + branch flipping
(capability parity: mythril/concolic/ — concolic_execution.py:67,
find_trace.py:45, concrete_data.py).

The port's copy of mythril_tpu/concolic/: host only, as the reference
(`engine="lockstep"` logs a line and runs no device code)."""

from .concolic_execution import concolic_execution
from .find_trace import concrete_execution

__all__ = ["concolic_execution", "concrete_execution"]
