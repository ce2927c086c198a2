"""EXP modeled as an uninterpreted Power function with concrete anchor constraints
(capability parity: mythril/laser/ethereum/function_managers/
exponent_function_manager.py:10).

The port's copy of mythril_tpu/core/function_managers/exponent_function_manager.py."""

from __future__ import annotations

from typing import List, Tuple

from ...smt import And, BitVec, Bool, Function, symbol_factory


class ExponentFunctionManager:
    def __init__(self):
        self.power = Function("Power", [256, 256], 256)
        self.log = Function("Log", [256], 256)

    def create_condition(self, base: BitVec, exponent: BitVec) -> Tuple[BitVec, Bool]:
        """Returns (power_expression, side_constraints)."""
        power = self.power(base, exponent)
        if base.raw.is_const and base.value == 256:
            # anchor the common 256**i pattern used for byte masks
            anchors: List[Bool] = []
            for i in range(32):
                anchors.append(
                    self.power(symbol_factory.BitVecVal(256, 256),
                               symbol_factory.BitVecVal(i, 256))
                    == symbol_factory.BitVecVal(256 ** i, 256))
            return power, And(*anchors)
        return power, symbol_factory.BoolVal(True)


exponent_function_manager = ExponentFunctionManager()
