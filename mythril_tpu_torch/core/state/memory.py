"""Symbolic byte-granular memory (API parity: mythril/laser/ethereum/state/memory.py:28).

Sparse dict keyed by simplified 256-bit address terms; symbolic addresses become keys
(aliasing resolved only syntactically, as in the reference). Word reads/writes are
big-endian 32-byte groups. `APPROX_ITR` caps solver-driven iteration on symbolic
slice bounds.

The port's copy of mythril_tpu/core/state/memory.py."""

from __future__ import annotations

from typing import Dict, List, Union

from ...smt import BitVec, Bool, Concat, Extract, If, simplify, symbol_factory
from ...utils.helpers import ceil32

APPROX_ITR = 100


def _key(item: Union[int, BitVec]):
    if isinstance(item, int):
        return item
    item = simplify(item)
    if item.raw.is_const:
        return item.raw.value
    return item.raw  # hash-consed term: stable identity key


class Memory:
    def __init__(self):
        self._msize = 0
        self._memory: Dict[object, Union[int, BitVec]] = {}

    def __len__(self) -> int:
        return self._msize

    def extend(self, size: int) -> None:
        self._msize += size

    def get_word_at(self, index: Union[int, BitVec]) -> BitVec:
        parts = []
        for offset in range(32):
            byte = self[index + offset]
            if isinstance(byte, int):
                byte = symbol_factory.BitVecVal(byte, 8)
            parts.append(byte)
        return simplify(Concat(*parts))

    def write_word_at(self, index: Union[int, BitVec], value: Union[int, BitVec, bool, Bool]) -> None:
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 256)
        elif isinstance(value, bool):
            value = symbol_factory.BitVecVal(1 if value else 0, 256)
        elif isinstance(value, Bool):
            value = If(value, symbol_factory.BitVecVal(1, 256),
                       symbol_factory.BitVecVal(0, 256))
        for offset in range(32):
            byte = simplify(Extract(255 - offset * 8, 248 - offset * 8, value))
            self[index + offset] = byte

    def __getitem__(self, item):
        if isinstance(item, slice):
            start = item.start or 0
            stop = item.stop if item.stop is not None else self._msize
            step = item.step or 1
            if not isinstance(start, int) or not isinstance(stop, int):
                return self._symbolic_slice(start, stop, step)
            return [self[i] for i in range(start, stop, step)]
        value = self._memory.get(_key(item))
        if value is None:
            return symbol_factory.BitVecVal(0, 8)
        return value

    def _symbolic_slice(self, start, stop, step):
        parts = []
        current = start if isinstance(start, BitVec) else symbol_factory.BitVecVal(start, 256)
        stop_bv = stop if isinstance(stop, BitVec) else symbol_factory.BitVecVal(stop, 256)
        for _ in range(APPROX_ITR):
            difference = simplify(stop_bv - current)
            if difference.raw.is_const and difference.raw.value == 0:
                break
            parts.append(self[current])
            current = simplify(current + step)
        return parts

    def __setitem__(self, key, value):
        if isinstance(key, slice):
            start = key.start or 0
            step = key.step or 1
            if key.stop is None:
                raise IndexError("open-ended memory slice write")
            for position, byte in zip(range(start, key.stop, step), value):
                self[position] = byte
            return
        if isinstance(value, int):
            assert 0 <= value <= 0xFF
            value = symbol_factory.BitVecVal(value, 8)
        if isinstance(value, BitVec):
            assert value.size() == 8, f"memory cell write of width {value.size()}"
        self._memory[_key(key)] = value

    def copy(self) -> "Memory":
        clone = Memory()
        clone._msize = self._msize
        clone._memory = dict(self._memory)
        return clone

    __copy__ = copy

    def __deepcopy__(self, memo):
        return self.copy()
