"""Machine state: stack (1024 limit), memory, pc, gas accounting
(API parity: mythril/laser/ethereum/state/machine_state.py — MachineStack:18,
MachineState:95, mem_extend:160, memory gas :138-157).

The port's copy of mythril_tpu/core/state/machine_state.py."""

from __future__ import annotations

from typing import List, Union

from ...exceptions import MythrilTpuBaseException
from ...smt import BitVec
from ...utils.helpers import ceil32

STACK_LIMIT = 1024
GAS_MEMORY = 3
GAS_MEMORY_QUADRATIC_DENOMINATOR = 512


class StackUnderflowException(IndexError, MythrilTpuBaseException):
    pass


class StackOverflowException(IndexError, MythrilTpuBaseException):
    pass


class MachineStack(list):
    STACK_LIMIT = STACK_LIMIT

    def append(self, element) -> None:
        if len(self) >= self.STACK_LIMIT:
            raise StackOverflowException(
                f"stack overflow: reached limit {self.STACK_LIMIT}")
        super().append(element)

    def pop(self, index=-1):
        try:
            return super().pop(index)
        except IndexError:
            raise StackUnderflowException("tried to pop from empty stack")

    def __getitem__(self, item):
        try:
            return super().__getitem__(item)
        except IndexError:
            raise StackUnderflowException("stack index out of range")

    def __add__(self, other):
        raise NotImplementedError("use append/extend on MachineStack")


class MachineState:
    def __init__(self, gas_limit: int, pc: int = 0, stack=None, subroutine_stack=None,
                 memory: "Memory" = None, constraints=None, depth: int = 0,
                 max_gas_used: int = 0, min_gas_used: int = 0,
                 prev_pc: int = -1):
        from .memory import Memory

        self.pc = pc
        self.stack = MachineStack(stack or [])
        self.subroutine_stack = MachineStack(subroutine_stack or [])
        # NOTE: `memory or Memory()` would discard a non-empty Memory whose _msize
        # is still 0 (len() is the EVM msize, not the cell count)
        self.memory = memory if memory is not None else Memory()
        self.gas_limit = gas_limit
        self.min_gas_used = min_gas_used
        self.max_gas_used = max_gas_used
        self.depth = depth
        self.prev_pc = prev_pc  # pc of the previously executed instruction

    def calculate_extension_size(self, start: int, size: int) -> int:
        if self.memory_size >= start + size:
            return 0
        return ceil32(start + size) - self.memory_size

    def calculate_memory_gas(self, start: int, size: int) -> int:
        """EVM quadratic memory gas for an extension to cover [start, start+size)."""
        if size == 0:
            return 0
        before = self.memory_size // 32
        after = ceil32(start + size) // 32
        extension_words = after - before
        if extension_words <= 0:
            return 0
        return (GAS_MEMORY * extension_words
                + (after * after) // GAS_MEMORY_QUADRATIC_DENOMINATOR
                - (before * before) // GAS_MEMORY_QUADRATIC_DENOMINATOR)

    def check_gas(self) -> None:
        """Out-of-gas check on the *minimum* estimate: only certainly-OOG paths die
        (symbolic execution keeps (min,max) gas estimates rather than exact gas)."""
        from ..util import OutOfGasException

        if self.min_gas_used > self.gas_limit:
            raise OutOfGasException(
                f"min gas {self.min_gas_used} exceeds limit {self.gas_limit}")

    def mem_extend(self, start: Union[int, BitVec], size: Union[int, BitVec]) -> None:
        from ..util import OutOfGasException

        if isinstance(start, BitVec):
            if start.raw.is_const:
                start = start.raw.value
            else:
                return  # symbolic offset: memory model is sparse, no extension
        if isinstance(size, BitVec):
            if size.raw.is_const:
                size = size.raw.value
            else:
                return
        if size == 0:
            return
        if start + size > 2 ** 32:
            # quadratic memory gas makes multi-GB extension unpayable with any
            # realistic gas limit: certain OOG
            raise OutOfGasException(f"memory extension to {start + size}")
        extension_size = self.calculate_extension_size(start, size)
        if extension_size > 0:
            gas = self.calculate_memory_gas(start, size)
            self.min_gas_used += gas
            self.max_gas_used += gas
            self.check_gas()
            self.memory.extend(extension_size)

    def pop(self, amount: int = 1):
        if amount == 1:
            return self.stack.pop()
        values = self.stack[-amount:][::-1]
        del self.stack[-amount:]
        return values

    @property
    def memory_size(self) -> int:
        return len(self.memory)

    @property
    def as_dict(self) -> dict:
        return {
            "pc": self.pc,
            "stack": [str(entry) for entry in self.stack],
            "memory_size": self.memory_size,
            "gas": {"min": self.min_gas_used, "max": self.max_gas_used},
            "depth": self.depth,
        }

    def __copy__(self):
        return MachineState(
            gas_limit=self.gas_limit, pc=self.pc, stack=list(self.stack),
            subroutine_stack=list(self.subroutine_stack), memory=self.memory.copy(),
            depth=self.depth, max_gas_used=self.max_gas_used,
            min_gas_used=self.min_gas_used, prev_pc=self.prev_pc)

    def __deepcopy__(self, memo):
        return self.__copy__()  # stack entries are immutable expressions

    def __str__(self):
        return f"MachineState(pc={self.pc}, stack_size={len(self.stack)})"
