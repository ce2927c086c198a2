"""Helper value model for POST modules and callgraph (API parity:
mythril/analysis/ops.py — VarType, Variable, Call, get_variable).

The port's copy of mythril_tpu/analysis/ops.py."""

from __future__ import annotations

from enum import Enum

from ..smt import BitVec


class VarType(Enum):
    SYMBOLIC = 1
    CONCRETE = 2


class Variable:
    def __init__(self, val, var_type: VarType):
        self.val = val
        self.type = var_type

    def __str__(self):
        return str(self.val)


def get_variable(expression) -> Variable:
    if isinstance(expression, int):
        return Variable(expression, VarType.CONCRETE)
    if isinstance(expression, BitVec) and expression.raw.is_const:
        return Variable(expression.value, VarType.CONCRETE)
    return Variable(expression, VarType.SYMBOLIC)


class Call:
    def __init__(self, node, state, state_index, call_type, to,
                 gas, value=Variable(0, VarType.CONCRETE), data=None):
        self.to = to
        self.gas = gas
        self.type = call_type
        self.node = node
        self.state = state
        self.state_index = state_index
        self.value = value
        self.data = data
