"""Wall-clock budget shared by engine and solver (API parity:
mythril/laser/ethereum/time_handler.py:5).

The port's copy of mythril_tpu/core/time_handler.py, unchanged.
"""

from __future__ import annotations

import time


class TimeHandler:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._start_time = None
            cls._instance._execution_time = None
        return cls._instance

    def start_execution(self, execution_time_seconds: int) -> None:
        self._start_time = int(time.time() * 1000)
        self._execution_time = execution_time_seconds * 1000

    def reset(self) -> None:
        """Disarm the budget (back to the never-started state). A finished
        analysis's expired clock must not clamp later standalone solver
        queries to a ~0ms budget."""
        self._start_time = None
        self._execution_time = None

    def time_remaining(self) -> int:
        """Milliseconds left in the global budget (large if never started)."""
        if self._start_time is None:
            return 100_000_000
        return self._execution_time - (int(time.time() * 1000) - self._start_time)


time_handler = TimeHandler()
