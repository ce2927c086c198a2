"""The port's SMT façade: the typed expressions over the term IR
(`Expression`, `BitVec`, `Bool`, `Array`, `Function`, `Model`), the
solvers (`Solver`, `Optimize`, `IndependenceSolver`) and `symbol_factory`,
copies of the JAX package's modules of the same names.

    from mythril_tpu_torch.smt import symbol_factory, Solver, UGT

Below them: the term IR (`terms`), SMT-LIB2 reading and writing (`smtlib`),
and under `solver/` simplification, lowering, bit-blasting to CNF, the
incremental pipeline and the port's own native CDCL (`solver/sat.py`, built
from mythril_tpu_torch/native/cdcl.cpp at first use). All of it runs on the
host; nothing here touches a device. `--solver jax` raises until the batch
dispatch is ported (ROADMAP A 10)."""

from __future__ import annotations

from typing import Optional, Set

from . import terms
from .expression import Expression, simplify
from .bitvec import (
    BitVec, UGT, UGE, ULT, ULE, SGT, SLT, UDiv, URem, SRem, SDiv, LShR,
    Concat, Extract, ZeroExt, SignExt, If, Sum,
    BVAddNoOverflow, BVMulNoOverflow, BVSubNoUnderflow,
)
from .bool import Bool, And, Or, Not, Xor, Implies
from .array import Array, BaseArray, K
from .function import Function
from .model import Model
from .solver.solver import BaseSolver, Solver, Optimize
from .solver.independence_solver import IndependenceSolver


class SymbolFactory:
    """All symbol creation funnels through here (reference smt/__init__.py:36-154)."""

    @staticmethod
    def BitVecVal(value: int, size: int, annotations: Optional[Set] = None) -> BitVec:
        return BitVec(terms.bv_const(value, size), annotations)

    @staticmethod
    def BitVecSym(name: str, size: int, annotations: Optional[Set] = None) -> BitVec:
        return BitVec(terms.bv_var(name, size), annotations)

    @staticmethod
    def BoolVal(value: bool, annotations: Optional[Set] = None) -> Bool:
        return Bool(terms.bool_const(value), annotations)

    @staticmethod
    def BoolSym(name: str, annotations: Optional[Set] = None) -> Bool:
        return Bool(terms.bool_var(name), annotations)


symbol_factory = SymbolFactory()

__all__ = [
    "terms", "Expression", "simplify", "BitVec", "Bool", "Array", "BaseArray", "K",
    "Function", "Model", "BaseSolver", "Solver", "Optimize", "IndependenceSolver",
    "symbol_factory", "SymbolFactory",
    "UGT", "UGE", "ULT", "ULE", "SGT", "SLT", "UDiv", "URem", "SRem", "SDiv", "LShR",
    "Concat", "Extract", "ZeroExt", "SignExt", "If", "Sum",
    "BVAddNoOverflow", "BVMulNoOverflow", "BVSubNoUnderflow",
    "And", "Or", "Not", "Xor", "Implies",
]
