"""Calldata models (API parity: mythril/laser/ethereum/state/calldata.py —
BaseCalldata:26, ConcreteCalldata:121, BasicConcreteCalldata:168, SymbolicCalldata:222,
BasicSymbolicCalldata:273).

Four backends behind one interface: byte reads return 8-bit BitVecs, word reads
concatenate 32 bytes; out-of-bounds symbolic reads yield 0 (EVM semantics);
`concrete(model)` reconstructs witness bytes for reports.

The port's copy of mythril_tpu/core/state/calldata.py."""

from __future__ import annotations

from typing import Any, List, Optional, Union

from ...smt import BitVec, Concat, Expression, If, K, Array, ULT, simplify, symbol_factory


class BaseCalldata:
    def __init__(self, tx_id):
        self.tx_id = tx_id

    @property
    def calldatasize(self) -> BitVec:
        result = self.size
        if isinstance(result, int):
            return symbol_factory.BitVecVal(result, 256)
        return result

    def get_word_at(self, offset: Union[int, BitVec]) -> BitVec:
        parts = [self[offset + i] for i in range(32)]
        return simplify(Concat(*parts))

    def __getitem__(self, item) -> Any:
        if isinstance(item, int) or isinstance(item, Expression):
            return self._load(item)
        if isinstance(item, slice):
            start = 0 if item.start is None else item.start
            step = 1 if item.step is None else item.step
            stop = self.size if item.stop is None else item.stop
            current_index = (start if isinstance(start, BitVec)
                             else symbol_factory.BitVecVal(start, 256))
            parts = []
            if isinstance(stop, int) and isinstance(start, int):
                for i in range(start, stop, step):
                    parts.append(self._load(i))
            else:
                # symbolic bounds: iterate with a solver-checked budget like the
                # reference's solver-driven slice iteration (calldata.py:66-95)
                from ...support.model import get_model
                from ...exceptions import UnsatError

                stop_bv = stop if isinstance(stop, BitVec) \
                    else symbol_factory.BitVecVal(stop, 256)
                # the feasibility probe below sees only the ULT, not the path
                # constraints, so an unconstrained symbolic stop never breaks the
                # loop: keep the iteration budget small
                for _ in range(64):
                    try:
                        get_model((ULT(current_index, stop_bv),))
                    except UnsatError:
                        break
                    parts.append(self._load(current_index))
                    current_index = simplify(current_index + step)
            return parts
        raise ValueError

    def _load(self, item) -> Any:
        raise NotImplementedError

    @property
    def size(self) -> Union[int, BitVec]:
        raise NotImplementedError

    def concrete(self, model) -> list:
        """Witness bytes under a model."""
        raise NotImplementedError


class ConcreteCalldata(BaseCalldata):
    """Concrete bytes backed by a constant array (reference keeps a z3 K-array so
    symbolic indexing still works)."""

    def __init__(self, tx_id, calldata: List[int]):
        self._calldata = K(256, 8, 0)
        for i, value in enumerate(calldata):
            self._calldata[i] = value
        self.concrete_calldata = list(calldata)
        super().__init__(tx_id)

    def _load(self, item) -> BitVec:
        if isinstance(item, int):
            try:
                return symbol_factory.BitVecVal(self.concrete_calldata[item], 8)
            except IndexError:
                return symbol_factory.BitVecVal(0, 8)
        item = simplify(item)
        return simplify(self._calldata[item])

    def concrete(self, model) -> list:
        return list(self.concrete_calldata)

    @property
    def size(self) -> int:
        return len(self.concrete_calldata)


class BasicConcreteCalldata(BaseCalldata):
    """Concrete bytes without the array backing (plain list reads)."""

    def __init__(self, tx_id, calldata: List[int]):
        self._calldata = list(calldata)
        super().__init__(tx_id)

    def _load(self, item) -> Any:
        if isinstance(item, int):
            try:
                return symbol_factory.BitVecVal(self._calldata[item], 8)
            except IndexError:
                return symbol_factory.BitVecVal(0, 8)
        value = symbol_factory.BitVecVal(0, 8)
        for index in range(len(self._calldata) - 1, -1, -1):
            value = If(item == index,
                       symbol_factory.BitVecVal(self._calldata[index], 8), value)
        return value

    def concrete(self, model) -> list:
        return list(self._calldata)

    @property
    def size(self) -> int:
        return len(self._calldata)


class SymbolicCalldata(BaseCalldata):
    """Fully symbolic calldata: Array(256->8) + symbolic size; OOB reads give 0."""

    def __init__(self, tx_id):
        self._size = symbol_factory.BitVecSym(f"{tx_id}_calldatasize", 256)
        self._calldata = Array(f"{tx_id}_calldata", 256, 8)
        super().__init__(tx_id)

    def _load(self, item) -> Any:
        item = symbol_factory.BitVecVal(item, 256) if isinstance(item, int) else item
        return simplify(If(ULT(item, self._size),
                           simplify(self._calldata[item]),
                           symbol_factory.BitVecVal(0, 8)))

    def concrete(self, model) -> list:
        # Witness extraction minimizes calldatasize; the clamp guards against an
        # unconstrained size under an un-minimized model (would loop ~2^256).
        concrete_length = min(model.eval(self.size), MAX_WITNESS_CALLDATA)
        result = []
        for i in range(concrete_length):
            value = model.eval(self._calldata[i])
            result.append(value)
        return result

    @property
    def size(self) -> BitVec:
        return self._size


#: hard cap on reconstructed witness calldata length
MAX_WITNESS_CALLDATA = 4096


class BasicSymbolicCalldata(BaseCalldata):
    """Symbolic calldata as a read journal (no array theory; reads recorded and
    cross-constrained lazily — reference calldata.py:273)."""

    def __init__(self, tx_id):
        self._reads: List[tuple] = []
        self._size = symbol_factory.BitVecSym(f"{tx_id}_calldatasize", 256)
        super().__init__(tx_id)

    def _load(self, item, clean: bool = False) -> Any:
        expr_item = (symbol_factory.BitVecVal(item, 256)
                     if isinstance(item, int) else item)
        symbolic_base_value = If(
            ULT(expr_item, self._size),
            symbol_factory.BitVecSym(
                f"{self.tx_id}_calldata_{str(expr_item.raw)}", 8),
            symbol_factory.BitVecVal(0, 8))
        return_value = symbolic_base_value
        for stored_item, stored_value in self._reads:
            return_value = If(expr_item == stored_item, stored_value, return_value)
        if not clean:
            self._reads.append((expr_item, symbolic_base_value))
        return simplify(return_value)

    def concrete(self, model) -> list:
        concrete_length = min(model.eval(self.size), MAX_WITNESS_CALLDATA)
        return [model.eval(self._load(i, clean=True)) for i in range(concrete_length)]

    @property
    def size(self) -> BitVec:
        return self._size
