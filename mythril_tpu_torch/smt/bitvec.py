"""BitVec wrapper + operator algebra (API parity: mythril/laser/smt/bitvec.py and
bitvec_helper.py). Conventions follow the reference/z3: `/` and `%` are signed
(SDiv/SRem); unsigned variants are the UDiv/URem/UGT/ULT/... helpers; comparison
operators return Bool; annotations union through every operation.

The port's copy of mythril_tpu/smt/bitvec.py, unchanged.
"""

from __future__ import annotations

from typing import Optional, Set, Union

from . import terms
from .bool import Bool
from .expression import Expression


def _coerce(other, width: int) -> terms.Term:
    if isinstance(other, BitVec):
        return other.raw
    if isinstance(other, int):
        return terms.bv_const(other, width)
    raise TypeError(f"cannot combine BitVec with {type(other)}")


def _union(a, b) -> Set:
    if isinstance(b, Expression):
        return a.annotations | b.annotations
    return a.annotations


class BitVec(Expression[terms.Term]):
    """A bit-vector expression of fixed width."""

    def __init__(self, raw: terms.Term, annotations: Optional[Set] = None):
        assert isinstance(raw.sort, int), f"not a bitvector sort: {raw.sort}"
        super().__init__(raw, annotations)

    def size(self) -> int:
        return self.raw.width

    @property
    def value(self) -> Optional[int]:
        return self.raw.value

    # -- arithmetic ----------------------------------------------------------------
    def _binop(self, op: str, other) -> "BitVec":
        return BitVec(terms.bv_binop(op, self.raw, _coerce(other, self.size())),
                      _union(self, other))

    def _rbinop(self, op: str, other) -> "BitVec":
        return BitVec(terms.bv_binop(op, _coerce(other, self.size()), self.raw),
                      _union(self, other))

    def __add__(self, other):
        return self._binop("bvadd", other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop("bvsub", other)

    def __rsub__(self, other):
        return self._rbinop("bvsub", other)

    def __mul__(self, other):
        return self._binop("bvmul", other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop("bvsdiv", other)

    def __rtruediv__(self, other):
        return self._rbinop("bvsdiv", other)

    __floordiv__ = __truediv__

    def __mod__(self, other):
        return self._binop("bvsrem", other)

    def __rmod__(self, other):
        return self._rbinop("bvsrem", other)

    def __and__(self, other):
        return self._binop("bvand", other)

    __rand__ = __and__

    def __or__(self, other):
        return self._binop("bvor", other)

    __ror__ = __or__

    def __xor__(self, other):
        return self._binop("bvxor", other)

    __rxor__ = __xor__

    def __lshift__(self, other):
        return self._binop("bvshl", other)

    def __rshift__(self, other):
        return self._binop("bvashr", other)  # z3 convention: >> is arithmetic

    def __invert__(self):
        return BitVec(terms.bv_not(self.raw), self.annotations)

    def __neg__(self):
        return BitVec(terms.bv_neg(self.raw), self.annotations)

    # -- comparisons (signed, z3 convention) -----------------------------------------
    def _cmp(self, op: str, other) -> Bool:
        return Bool(terms.bv_cmp(op, self.raw, _coerce(other, self.size())),
                    _union(self, other))

    def __eq__(self, other) -> Bool:  # type: ignore[override]
        return self._cmp("eq", other)

    def __ne__(self, other) -> Bool:  # type: ignore[override]
        return Bool(terms.bool_not(
            terms.bv_cmp("eq", self.raw, _coerce(other, self.size()))),
            _union(self, other))

    def __lt__(self, other) -> Bool:
        return self._cmp("bvslt", other)

    def __le__(self, other) -> Bool:
        return self._cmp("bvsle", other)

    def __gt__(self, other) -> Bool:
        return Bool(terms.bv_cmp("bvslt", _coerce(other, self.size()), self.raw),
                    _union(self, other))

    def __ge__(self, other) -> Bool:
        return Bool(terms.bv_cmp("bvsle", _coerce(other, self.size()), self.raw),
                    _union(self, other))

    def __hash__(self):
        return self.raw._hash


# -- free helpers (API parity: mythril/laser/smt/bitvec_helper.py) -------------------

def _bv(value: Union[BitVec, int], width: int) -> terms.Term:
    return _coerce(value, width)


def _w(a, b) -> int:
    if isinstance(a, BitVec):
        return a.size()
    if isinstance(b, BitVec):
        return b.size()
    raise TypeError("need at least one BitVec")


def UGT(a, b) -> Bool:
    w = _w(a, b)
    return Bool(terms.bv_cmp("bvult", _bv(b, w), _bv(a, w)), _union_of(a, b))


def UGE(a, b) -> Bool:
    w = _w(a, b)
    return Bool(terms.bv_cmp("bvule", _bv(b, w), _bv(a, w)), _union_of(a, b))


def ULT(a, b) -> Bool:
    w = _w(a, b)
    return Bool(terms.bv_cmp("bvult", _bv(a, w), _bv(b, w)), _union_of(a, b))


def ULE(a, b) -> Bool:
    w = _w(a, b)
    return Bool(terms.bv_cmp("bvule", _bv(a, w), _bv(b, w)), _union_of(a, b))


def SGT(a, b) -> Bool:
    w = _w(a, b)
    return Bool(terms.bv_cmp("bvslt", _bv(b, w), _bv(a, w)), _union_of(a, b))


def SLT(a, b) -> Bool:
    w = _w(a, b)
    return Bool(terms.bv_cmp("bvslt", _bv(a, w), _bv(b, w)), _union_of(a, b))


def UDiv(a, b) -> BitVec:
    w = _w(a, b)
    return BitVec(terms.bv_binop("bvudiv", _bv(a, w), _bv(b, w)), _union_of(a, b))


def URem(a, b) -> BitVec:
    w = _w(a, b)
    return BitVec(terms.bv_binop("bvurem", _bv(a, w), _bv(b, w)), _union_of(a, b))


def SRem(a, b) -> BitVec:
    w = _w(a, b)
    return BitVec(terms.bv_binop("bvsrem", _bv(a, w), _bv(b, w)), _union_of(a, b))


def SDiv(a, b) -> BitVec:
    w = _w(a, b)
    return BitVec(terms.bv_binop("bvsdiv", _bv(a, w), _bv(b, w)), _union_of(a, b))


def LShR(a, b) -> BitVec:
    w = _w(a, b)
    return BitVec(terms.bv_binop("bvlshr", _bv(a, w), _bv(b, w)), _union_of(a, b))


def Concat(*parts) -> BitVec:
    raws = []
    annotations: Set = set()
    for part in parts:
        if isinstance(part, BitVec):
            raws.append(part.raw)
            annotations |= part.annotations
        else:
            raise TypeError("Concat needs BitVecs")
    return BitVec(terms.concat(*raws), annotations)


def Extract(high: int, low: int, operand: BitVec) -> BitVec:
    return BitVec(terms.extract(high, low, operand.raw), operand.annotations)


def ZeroExt(extra: int, operand: BitVec) -> BitVec:
    return BitVec(terms.zext(operand.raw, extra), operand.annotations)


def SignExt(extra: int, operand: BitVec) -> BitVec:
    return BitVec(terms.sext(operand.raw, extra), operand.annotations)


def If(cond, then, otherwise):
    from .bool import Bool as BoolT

    if not isinstance(cond, BoolT):
        cond = BoolT(terms.bool_const(bool(cond)))
    annotations = set(cond.annotations)
    if isinstance(then, Expression):
        annotations |= then.annotations
    if isinstance(otherwise, Expression):
        annotations |= otherwise.annotations
    # Array-valued If (state-merge: merged storage = If(c, s1, s2))
    for branch in (then, otherwise):
        if isinstance(branch, Expression) and isinstance(branch.raw.sort,
                                                         terms.ArraySort):
            from .array import BaseArray

            return BaseArray(terms.ite(cond.raw, then.raw, otherwise.raw),
                             annotations)
    width = None
    for branch in (then, otherwise):
        if isinstance(branch, BitVec):
            width = branch.size()
    if width is not None:
        then_raw = _bv(then, width)
        other_raw = _bv(otherwise, width)
        return BitVec(terms.ite(cond.raw, then_raw, other_raw), annotations)
    # Bool-valued If
    then_raw = then.raw if isinstance(then, BoolT) else terms.bool_const(bool(then))
    other_raw = otherwise.raw if isinstance(otherwise, BoolT) \
        else terms.bool_const(bool(otherwise))
    return BoolT(terms.ite(cond.raw, then_raw, other_raw), annotations)


def Sum(*operands: BitVec) -> BitVec:
    total = operands[0]
    for operand in operands[1:]:
        total = total + operand
    return total


def BVAddNoOverflow(a, b, signed: bool) -> Bool:
    """True iff a + b does not overflow (z3 API-parity helper for SWC-101)."""
    w = _w(a, b)
    ar, br = _bv(a, w), _bv(b, w)
    if signed:
        wide = terms.bv_binop("bvadd", terms.sext(ar, 1), terms.sext(br, 1))
        narrow = terms.sext(terms.bv_binop("bvadd", ar, br), 1)
    else:
        wide = terms.bv_binop("bvadd", terms.zext(ar, 1), terms.zext(br, 1))
        narrow = terms.zext(terms.bv_binop("bvadd", ar, br), 1)
    return Bool(terms.bv_cmp("eq", wide, narrow), _union_of(a, b))


def BVMulNoOverflow(a, b, signed: bool) -> Bool:
    w = _w(a, b)
    ar, br = _bv(a, w), _bv(b, w)
    if signed:
        wide = terms.bv_binop("bvmul", terms.sext(ar, w), terms.sext(br, w))
        narrow = terms.sext(terms.bv_binop("bvmul", ar, br), w)
    else:
        wide = terms.bv_binop("bvmul", terms.zext(ar, w), terms.zext(br, w))
        narrow = terms.zext(terms.bv_binop("bvmul", ar, br), w)
    return Bool(terms.bv_cmp("eq", wide, narrow), _union_of(a, b))


def BVSubNoUnderflow(a, b, signed: bool) -> Bool:
    w = _w(a, b)
    ar, br = _bv(a, w), _bv(b, w)
    if signed:
        wide = terms.bv_binop("bvsub", terms.sext(ar, 1), terms.sext(br, 1))
        narrow = terms.sext(terms.bv_binop("bvsub", ar, br), 1)
        return Bool(terms.bv_cmp("eq", wide, narrow), _union_of(a, b))
    return Bool(terms.bv_cmp("bvule", br, ar), _union_of(a, b))


def _union_of(a, b) -> Set:
    annotations: Set = set()
    if isinstance(a, Expression):
        annotations |= a.annotations
    if isinstance(b, Expression):
        annotations |= b.annotations
    return annotations
