"""GlobalState: one node of the symbolic execution tree (API parity:
mythril/laser/ethereum/state/global_state.py:21 — __copy__:62, new_bitvec:141,
annotations API :153-180).

Copying a GlobalState is THE forking cost center in the reference
(instructions.py deepcopy on every JUMPI); here expressions are immutable and
hash-consed so copies are shallow wrapper clones.

The port's copy of mythril_tpu/core/state/global_state.py."""

from __future__ import annotations

import copy as copy_module
from typing import Dict, Iterable, List, Optional, TYPE_CHECKING

from ...smt import BitVec, symbol_factory
from .annotation import StateAnnotation
from .environment import Environment
from .machine_state import MachineState
from .world_state import WorldState

if TYPE_CHECKING:
    from ..transaction.transaction_models import BaseTransaction


class GlobalState:
    def __init__(self, world_state: WorldState, environment: Environment,
                 node=None, machine_state: Optional[MachineState] = None,
                 transaction_stack: Optional[List] = None,
                 last_return_data=None,
                 annotations: Optional[List[StateAnnotation]] = None):
        self.node = node
        self.world_state = world_state
        self.environment = environment
        self.mstate = machine_state or MachineState(gas_limit=1000000000)
        self.transaction_stack = transaction_stack or []
        self.op_code = ""
        self.last_return_data = last_return_data
        self._annotations = annotations or []

    @property
    def accounts(self) -> Dict:
        return self.world_state.accounts

    def __copy__(self) -> "GlobalState":
        world_state = copy_module.copy(self.world_state)
        environment = copy_module.copy(self.environment)
        environment.active_account = world_state.accounts[
            environment.active_account.address.raw.value]
        mstate = copy_module.copy(self.mstate)
        transaction_stack = list(self.transaction_stack)
        environment.code = self.environment.code
        state = GlobalState(world_state, environment, self.node, mstate,
                            transaction_stack=transaction_stack,
                            last_return_data=self.last_return_data,
                            annotations=[copy_module.copy(a) for a in self._annotations])
        state.op_code = self.op_code
        return state

    def __deepcopy__(self, memo) -> "GlobalState":
        return self.__copy__()

    # -- instruction access --------------------------------------------------------
    def get_current_instruction(self) -> Dict:
        instructions = self.environment.code.instruction_list
        if self.mstate.pc >= len(instructions):
            return {"address": self.mstate.pc, "opcode": "STOP"}
        return instructions[self.mstate.pc].to_dict()

    @property
    def current_transaction(self) -> Optional["BaseTransaction"]:
        try:
            return self.transaction_stack[-1][0]
        except IndexError:
            return None

    @property
    def instruction(self) -> Dict:
        return self.get_current_instruction()

    def new_bitvec(self, name: str, size: int = 256, annotations=None) -> BitVec:
        transaction_id = self.current_transaction.id if self.current_transaction else "fresh"
        return symbol_factory.BitVecSym(f"{transaction_id}_{name}", size,
                                        annotations=annotations)

    # -- annotations ---------------------------------------------------------------
    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)
        if annotation.persist_to_world_state:
            self.world_state.annotate(annotation)

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type) -> Iterable:
        return filter(lambda a: isinstance(a, annotation_type), self._annotations)
