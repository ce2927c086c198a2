"""EIP-1153 transient storage with call-frame journaling (API parity:
mythril/laser/ethereum/state/transient_storage.py:5).

TSTORE/TLOAD live per (address, slot) for the duration of one outer transaction;
frames checkpoint on message-call entry and roll back on revert.

The port's copy of mythril_tpu/core/state/transient_storage.py."""

from __future__ import annotations

from typing import List

from ...smt import Array, BitVec, Concat, simplify


class TransientStorage:
    def __init__(self):
        self._storage = Array("transient_storage", 512, 256)
        self._checkpoints: List = [self._storage.raw]

    def _key(self, address: BitVec, slot: BitVec):
        return simplify(Concat(address, slot))

    def get(self, address: BitVec, slot: BitVec) -> BitVec:
        return simplify(self._storage[self._key(address, slot)])

    def set(self, address: BitVec, slot: BitVec, value: BitVec) -> None:
        self._storage[self._key(address, slot)] = value

    def checkpoint(self) -> None:
        self._checkpoints.append(self._storage.raw)

    def commit(self) -> None:
        if len(self._checkpoints) > 1:
            self._checkpoints.pop()

    def rollback(self) -> None:
        if len(self._checkpoints) > 1:
            self._storage.raw = self._checkpoints.pop()

    def clear(self) -> None:
        """New outer transaction: all transient slots reset to zero."""
        self.__init__()

    def __deepcopy__(self, memo):
        clone = TransientStorage.__new__(TransientStorage)
        from ...smt.expression import Expression

        clone._storage = Array.__new__(Array)
        Expression.__init__(clone._storage, self._storage.raw,
                            self._storage.annotations)
        clone._checkpoints = list(self._checkpoints)
        return clone
