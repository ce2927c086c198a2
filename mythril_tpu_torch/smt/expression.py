"""Typed expression facade base (API parity: mythril/laser/smt/expression.py:10).

Every wrapper carries `.raw` (a Term from the owned IR, where the reference holds a z3
AST) and an `annotations` set. Taint tracking lives here exactly as in the reference:
every derived expression unions its operands' annotation sets, which is what the
detection modules rely on to trace data flow to sinks.

The port's copy of mythril_tpu/smt/expression.py, unchanged.
"""

from __future__ import annotations

from typing import Generic, Optional, Set, TypeVar

from . import terms

T = TypeVar("T", bound=terms.Term)


class Expression(Generic[T]):
    __slots__ = ("raw", "_annotations")

    def __init__(self, raw: terms.Term, annotations: Optional[Set] = None):
        self.raw = raw
        self._annotations = frozenset(annotations) if annotations else frozenset()

    @property
    def annotations(self) -> Set:
        return self._annotations

    def annotate(self, annotation) -> None:
        self._annotations = self._annotations | {annotation}

    def get_annotations(self, annotation_type: type):
        return [a for a in self._annotations if isinstance(a, annotation_type)]

    def simplify(self) -> None:
        """Simplification is applied eagerly at construction in this build; kept for
        API compatibility (the reference calls z3 simplify here)."""

    @property
    def symbolic(self) -> bool:
        return not self.raw.is_const

    def __copy__(self):
        clone = type(self).__new__(type(self))
        Expression.__init__(clone, self.raw, self._annotations)
        return clone

    def __deepcopy__(self, memo):
        # terms are immutable + hash-consed: a deep copy must NOT rebuild the graph
        return self.__copy__()

    def __repr__(self):
        return repr(self.raw)


def simplify(expression: Expression) -> Expression:
    """API-parity helper; construction-time rewriting already normalized `raw`."""
    expression.simplify()
    return expression
