"""SWC-110 Assert violation (capability parity:
mythril/analysis/module/modules/exceptions.py — reachable INVALID, plus
Solidity >=0.8 assertion failures, which REVERT with Panic(uint256) code 1;
the last JUMP address is tracked as the issue's source location).

The port's copy of mythril_tpu/analysis/modules/exceptions.py."""

from __future__ import annotations

import logging
from typing import Optional

from ...core.state.annotation import StateAnnotation
from ...core.state.global_state import GlobalState
from ...core.util import get_concrete_int
from ...exceptions import UnsatError
from ...utils.helpers import get_code_hash
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import ASSERT_VIOLATION

log = logging.getLogger(__name__)

#: function selector of Panic(uint256)
PANIC_SIGNATURE = [78, 72, 123, 113]


class LastJumpAnnotation(StateAnnotation):
    """Tracks the last JUMP address: the assert's jump-over branch, used as
    the issue's source location (reference exceptions.py:25)."""

    def __init__(self, last_jump: Optional[int] = None) -> None:
        self.last_jump = last_jump

    def __copy__(self):
        return LastJumpAnnotation(self.last_jump)


def is_assertion_failure(state: GlobalState) -> bool:
    """A REVERT is an assertion failure iff its return data is
    Panic(uint256) with code 1 (reference exceptions.py:140-150)."""
    mstate = state.mstate
    offset, length = mstate.stack[-1], mstate.stack[-2]
    try:
        start = get_concrete_int(offset)
        end = get_concrete_int(offset + length)
    except Exception:
        return False
    return_data = []
    for raw_byte in mstate.memory[start:end]:
        if not raw_byte.raw.is_const:
            return False
        return_data.append(raw_byte.raw.value)
    if len(return_data) < 5:
        return False
    return return_data[:4] == PANIC_SIGNATURE and return_data[-1] == 1


class Exceptions(DetectionModule):
    name = "Assertion violation"
    swc_id = ASSERT_VIOLATION
    description = "Check whether an exception is triggered (reachable INVALID " \
                  "or Panic(1) revert)."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["INVALID", "JUMP", "REVERT"]
    # presence-only: a constant invalid JUMP dest is a real assert-style
    # finding, so untainted sites must still run the hook
    taint_sinks = {"INVALID": (), "JUMP": ()}

    def __init__(self):
        super().__init__()
        self.auto_cache = False  # cache is keyed by source location instead

    def _execute(self, state: GlobalState):
        instruction = state.get_current_instruction()
        opcode = instruction["opcode"]

        annotations = list(state.get_annotations(LastJumpAnnotation))
        if not annotations:
            state.annotate(LastJumpAnnotation())
            annotations = list(state.get_annotations(LastJumpAnnotation))

        if opcode == "JUMP":
            annotations[0].last_jump = instruction["address"]
            return []
        if opcode == "REVERT" and not is_assertion_failure(state):
            return []

        source_location = annotations[0].last_jump
        code_hash = get_code_hash(state.environment.code.bytecode)
        if (source_location, code_hash) in self.cache:
            return []

        constraints = state.world_state.constraints.get_all_constraints()
        try:
            transaction_sequence = get_transaction_sequence(state, constraints)
        except UnsatError:
            return []
        issue = Issue(
            contract=state.environment.active_account.contract_name,
            function_name=getattr(state.environment, "active_function_name",
                                  "fallback"),
            address=instruction["address"],
            swc_id=self.swc_id,
            title="Exception State",
            severity="Medium",
            bytecode=state.environment.code.bytecode,
            description_head="An assertion violation was triggered.",
            description_tail=(
                "It is possible to trigger an assertion violation. Note that "
                "Solidity assert() statements should only be used to check "
                "invariants. Review the transaction trace generated for this "
                "issue and either make sure your program logic is correct, or "
                "use require() instead of assert() if your goal is to constrain "
                "user inputs or enforce preconditions."),
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
        )
        issue.source_location = source_location
        self.cache.add((source_location, code_hash))
        attach_issue_annotation(state, issue, self, constraints)
        return [issue]
