"""Report extra-data carrier filled by plugins (API parity:
mythril/laser/execution_info.py:4).

The port's copy of mythril_tpu/core/execution_info.py."""

from __future__ import annotations


class ExecutionInfo:
    def as_dict(self) -> dict:
        raise NotImplementedError
