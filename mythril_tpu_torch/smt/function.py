"""Uninterpreted functions (API parity: mythril/laser/smt/function.py:7).

Used by the keccak and exponent function managers; applications become `apply` terms
that the solver pipeline Ackermann-expands (smt/solver/preprocess.py).

The port's copy of mythril_tpu/smt/function.py, unchanged.
"""

from __future__ import annotations

from typing import List, Sequence, Union

from . import terms
from .bitvec import BitVec, _coerce


class Function:
    """f: BitVec(d0) x ... x BitVec(dn) -> BitVec(range_width)."""

    def __init__(self, name: str, domain: Union[int, Sequence[int]], value_range: int):
        if isinstance(domain, int):
            domain = [domain]
        self.name = name
        self.domain: List[int] = list(domain)
        self.range = value_range

    def __call__(self, *args) -> BitVec:
        raw_args = tuple(_coerce(a, w) for a, w in zip(args, self.domain))
        annotations = set()
        for arg in args:
            if isinstance(arg, BitVec):
                annotations |= arg.annotations
        return BitVec(terms.apply_uf(self.name, raw_args, tuple(self.domain),
                                     self.range), annotations)

    def __eq__(self, other):
        return (isinstance(other, Function) and self.name == other.name
                and self.domain == other.domain and self.range == other.range)

    def __hash__(self):
        return hash((self.name, tuple(self.domain), self.range))
