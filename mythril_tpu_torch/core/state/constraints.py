"""Path-constraint container (API parity: mythril/laser/ethereum/state/constraints.py:12).

A list of Bool expressions; `is_possible()` funnels through support.model.get_model so
all satisfiability checks share the model cache. The keccak function manager's lazy
axioms are appended via get_all_constraints (mirroring the reference's
state/constraints.py:76-79 coupling, kept deliberately).

The port's copy of mythril_tpu/core/state/constraints.py."""

from __future__ import annotations

from typing import Iterable, List, Optional

from ...smt import Bool, symbol_factory


class Constraints(list):
    def __init__(self, constraint_list: Optional[Iterable[Bool]] = None):
        super().__init__(constraint_list or [])

    def is_possible(self, solver_timeout: Optional[int] = None) -> bool:
        from ...support.model import get_model
        from ...exceptions import UnsatError

        try:
            return get_model(tuple(self.get_all_constraints()),
                             solver_timeout=solver_timeout) is not None
        except UnsatError:
            return False

    def append(self, constraint: Bool) -> None:
        if isinstance(constraint, bool):
            constraint = symbol_factory.BoolVal(constraint)
        super().append(constraint)

    def pop(self, index: int = -1):
        return super().pop(index)

    def get_all_constraints(self) -> List[Bool]:
        from ..function_managers import keccak_function_manager

        return list(self) + keccak_function_manager.create_conditions()

    @property
    def as_list(self) -> List[Bool]:
        return list(self)

    def __copy__(self) -> "Constraints":
        return Constraints(list(self))

    def copy(self) -> "Constraints":
        return Constraints(list(self))

    def __deepcopy__(self, memo) -> "Constraints":
        return self.__copy__()  # Bool expressions are immutable: shallow is deep

    def __add__(self, other) -> "Constraints":
        result = Constraints(list(self))
        for constraint in other:
            result.append(constraint)
        return result

    def __iadd__(self, other) -> "Constraints":
        for constraint in other:
            self.append(constraint)
        return self
