"""Array wrappers (API parity: mythril/laser/smt/array.py — BaseArray/Array/K).

The port's copy of mythril_tpu/smt/array.py, unchanged.
"""

from __future__ import annotations

from typing import Optional, Set

from . import terms
from .bitvec import BitVec, _coerce
from .expression import Expression


class BaseArray(Expression[terms.Term]):
    """Bit-vector-indexed array. `array[index]` selects, `array[index] = value`
    produces an updated array IN PLACE by swapping `raw` (matching the mutable-feel
    surface the reference exposes on its z3 wrappers)."""

    def __init__(self, raw: terms.Term, annotations: Optional[Set] = None):
        assert isinstance(raw.sort, terms.ArraySort)
        super().__init__(raw, annotations)

    @property
    def index_width(self) -> int:
        return self.raw.sort.index_width

    @property
    def value_width(self) -> int:
        return self.raw.sort.value_width

    def __getitem__(self, index) -> BitVec:
        index_raw = _coerce(index, self.index_width)
        annotations = self.annotations
        if isinstance(index, Expression):
            annotations = annotations | index.annotations
        return BitVec(terms.select(self.raw, index_raw), annotations)

    def __setitem__(self, index, value) -> None:
        index_raw = _coerce(index, self.index_width)
        value_raw = _coerce(value, self.value_width)
        if isinstance(value, Expression):
            self._annotations = self._annotations | value.annotations
        if isinstance(index, Expression):
            self._annotations = self._annotations | index.annotations
        self.raw = terms.store(self.raw, index_raw, value_raw)

    def substitute(self, mapping) -> None:
        raw_map = {k.raw: v.raw for k, v in mapping.items()}
        self.raw = terms.substitute(self.raw, raw_map)


class Array(BaseArray):
    """A fresh symbolic array variable."""

    def __init__(self, name: str, index_width: int, value_width: int):
        super().__init__(terms.array_var(name, index_width, value_width))


class K(BaseArray):
    """A constant array: every cell holds `value` until stored over."""

    def __init__(self, index_width: int, value_width: int, value):
        value_raw = value.raw if isinstance(value, BitVec) \
            else terms.bv_const(value, value_width)
        super().__init__(terms.const_array(index_width, value_raw))
