"""RETURNDATA buffer (API parity: mythril/laser/ethereum/state/return_data.py:9).

The port's copy of mythril_tpu/core/state/return_data.py."""

from __future__ import annotations

from typing import List, Union

from ...smt import BitVec, symbol_factory


class ReturnData:
    def __init__(self, return_data: List[BitVec], return_data_size: Union[int, BitVec]):
        self.return_data = return_data
        if isinstance(return_data_size, int):
            return_data_size = symbol_factory.BitVecVal(return_data_size, 256)
        self.return_data_size = return_data_size

    @property
    def size(self) -> BitVec:
        return self.return_data_size

    def __getitem__(self, index):
        if isinstance(index, slice):
            start = index.start or 0
            stop = index.stop if index.stop is not None else len(self.return_data)
            return [self[i] for i in range(start, stop)]
        if isinstance(index, int):
            if index < len(self.return_data):
                return self.return_data[index]
            return symbol_factory.BitVecVal(0, 8)
        # symbolic index: fold over known cells
        from ...smt import If

        value = symbol_factory.BitVecVal(0, 8)
        for i in range(len(self.return_data) - 1, -1, -1):
            value = If(index == i, self.return_data[i], value)
        return value
