"""Engine helpers (API parity: mythril/laser/ethereum/util.py subset actually used).

The port's copy of mythril_tpu/core/util.py."""

from __future__ import annotations

from typing import List, Optional, Union

from ..smt import BitVec, symbol_factory
from ..exceptions import MythrilTpuBaseException


class VmException(MythrilTpuBaseException):
    pass


class OutOfGasException(VmException):
    pass


class InvalidJumpDestination(VmException):
    pass


class InvalidInstruction(VmException):
    pass


class WriteProtection(VmException):
    """State mutation attempted inside STATICCALL context."""


def get_instruction_index(instruction_list: List, address: int) -> Optional[int]:
    """Map byte address -> index in the instruction list (jump targets)."""
    index = 0
    for instr in instruction_list:
        if instr.address == address:
            return index
        index += 1
    return None


def get_concrete_int(item: Union[int, BitVec]) -> int:
    if isinstance(item, int):
        return item
    if item.raw.is_const:
        return item.value
    raise TypeError(f"expected concrete value, got symbolic {item}")


def concrete_int_from_bytes(data: bytes, start_index: int) -> int:
    from ..utils.helpers import zpad

    word = zpad(bytes(data[start_index:start_index + 32]), 32)
    return int.from_bytes(word, "big")


def concrete_int_to_bytes(value: Union[int, BitVec]) -> bytes:
    if isinstance(value, BitVec):
        value = value.value
    return value.to_bytes(32, "big")
