"""Bool wrapper + connectives (API parity: mythril/laser/smt/bool.py).

The port's copy of mythril_tpu/smt/bool.py, unchanged.
"""

from __future__ import annotations

from typing import Optional, Set

from . import terms
from .expression import Expression


class Bool(Expression[terms.Term]):
    def __init__(self, raw: terms.Term, annotations: Optional[Set] = None):
        assert raw.sort == terms.BOOL, f"not a bool sort: {raw.sort}"
        super().__init__(raw, annotations)

    @property
    def is_true(self) -> bool:
        return self.raw is terms.TRUE

    @property
    def is_false(self) -> bool:
        return self.raw is terms.FALSE

    @property
    def value(self) -> Optional[bool]:
        if self.is_true:
            return True
        if self.is_false:
            return False
        return None

    def __eq__(self, other) -> "Bool":  # type: ignore[override]
        if isinstance(other, Bool):
            return Bool(terms.bool_not(terms.bool_xor(self.raw, other.raw)),
                        self.annotations | other.annotations)
        return Bool(terms.bool_const(False))

    def __ne__(self, other) -> "Bool":  # type: ignore[override]
        if isinstance(other, Bool):
            return Bool(terms.bool_xor(self.raw, other.raw),
                        self.annotations | other.annotations)
        return Bool(terms.bool_const(True))

    def __and__(self, other) -> "Bool":
        return And(self, other)

    def __or__(self, other) -> "Bool":
        return Or(self, other)

    def __invert__(self) -> "Bool":
        return Not(self)

    def __bool__(self) -> bool:
        # Only concretely-true counts, mirroring z3's is_true usage in the reference.
        return self.is_true

    def substitute(self, mapping) -> "Bool":
        raw_map = {k.raw: v.raw for k, v in mapping.items()}
        return Bool(terms.substitute(self.raw, raw_map), self.annotations)

    def __hash__(self):
        return self.raw._hash


def And(*operands) -> Bool:
    annotations: Set = set()
    raws = []
    for operand in operands:
        if isinstance(operand, bool):
            operand = Bool(terms.bool_const(operand))
        annotations |= operand.annotations
        raws.append(operand.raw)
    return Bool(terms.bool_and(*raws), annotations)


def Or(*operands) -> Bool:
    annotations: Set = set()
    raws = []
    for operand in operands:
        if isinstance(operand, bool):
            operand = Bool(terms.bool_const(operand))
        annotations |= operand.annotations
        raws.append(operand.raw)
    return Bool(terms.bool_or(*raws), annotations)


def Not(operand: Bool) -> Bool:
    return Bool(terms.bool_not(operand.raw), operand.annotations)


def Xor(a: Bool, b: Bool) -> Bool:
    return Bool(terms.bool_xor(a.raw, b.raw), a.annotations | b.annotations)


def Implies(a: Bool, b: Bool) -> Bool:
    return Bool(terms.bool_implies(a.raw, b.raw), a.annotations | b.annotations)
