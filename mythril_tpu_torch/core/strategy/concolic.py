"""Concolic strategy: follow a recorded trace, flip chosen branches (API parity:
mythril/laser/ethereum/strategy/concolic.py:37 — trace following + branch flipping
via solving Not(condition)).

The port's copy of mythril_tpu/core/strategy/concolic.py."""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from ...exceptions import UnsatError
from ..state.global_state import GlobalState
from .basic import BasicSearchStrategy

log = logging.getLogger(__name__)


class TraceAnnotation:
    """Annotation tracking how far along the recorded trace this state is."""

    def __init__(self, trace_index: int = 0):
        self.trace_index = trace_index

    def __copy__(self):
        return TraceAnnotation(self.trace_index)


class ConcolicStrategy(BasicSearchStrategy):
    """work_list states follow `trace` (list of (pc_address, tx_id)); at JUMPIs whose
    address is in flip_branch_addresses, the negated branch is explored and its
    constraints solved to produce new concrete inputs."""

    def __init__(self, work_list, max_depth, trace: List[Tuple[int, str]] = None,
                 flip_branch_addresses: List[str] = None, **kwargs):
        super().__init__(work_list, max_depth)
        self.trace = trace or []
        self.flip_branch_addresses = flip_branch_addresses or []
        #: branch address -> solved concrete input dicts
        self.results: Dict[str, Dict] = {}

    def get_strategic_global_state(self) -> GlobalState:
        """Follow the recorded trace; solve deviating states at flip targets
        (reference strategy/concolic.py:66-115)."""
        while self.work_list:
            state = self.work_list.pop()
            annotations = list(state.get_annotations(TraceAnnotation))
            if annotations:
                annotation = annotations[0]
            else:
                annotation = TraceAnnotation()
                state.annotate(annotation)

            index = annotation.trace_index
            try:
                address = state.get_current_instruction()["address"]
            except IndexError:
                continue
            if index < len(self.trace) and self.trace[index][0] == address:
                annotation.trace_index += 1
                return state

            # deviation from the trace: this state took the OTHER side of the
            # last JUMPI; if that branch is a flip target, its constraints
            # describe exactly the inputs that flip it
            jumpi_address = self._previous_address(state)
            key = hex(jumpi_address) if jumpi_address is not None else None
            if key is not None and \
                    (key in self.flip_branch_addresses
                     or str(jumpi_address) in self.flip_branch_addresses) \
                    and key not in self.results:
                from ...analysis.solver import get_transaction_sequence

                try:
                    self.results[key] = get_transaction_sequence(
                        state,
                        state.world_state.constraints.get_all_constraints())
                except UnsatError:
                    log.debug("branch at %s cannot be flipped", key)
        raise StopIteration

    @staticmethod
    def _previous_address(state: GlobalState):
        prev_pc = state.mstate.prev_pc
        instruction_list = state.environment.code.instruction_list
        if prev_pc is None or not (0 <= prev_pc < len(instruction_list)):
            return None
        return instruction_list[prev_pc].address

    def run_check(self) -> bool:
        return len(self.results) != len(self.flip_branch_addresses)
