"""SWC-123 Requirement violation (capability parity:
mythril/analysis/module/modules/requirements_violation.py: a nested call reverts
on a require() whose condition is fed by the calling contract).

The port's copy of mythril_tpu/analysis/modules/requirements_violation.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import REQUIREMENT_VIOLATION

log = logging.getLogger(__name__)


class RequirementsViolation(DetectionModule):
    name = "Requirement violation in a nested call"
    swc_id = REQUIREMENT_VIOLATION
    description = ("Check whether a nested message call reverts due to a "
                   "require() over caller-provided inputs.")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["REVERT"]
    taint_sinks = {"REVERT": ()}

    def _execute(self, state: GlobalState):
        # only reverts inside a NESTED frame qualify (the calling contract
        # passed inputs that violate the callee's requirement)
        if len(state.transaction_stack) < 2:
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
            address=state.get_current_instruction()["address"],
            swc_id=self.swc_id,
            bytecode=state.environment.code.bytecode,
            title="Requirement Violation",
            severity="Medium",
            description_head="A requirement was violated in a nested call and "
                             "the call was reverted as a result.",
            description_tail=(
                "Make sure valid inputs are provided to the nested call (for "
                "instance, via passed arguments). A reachable requirement "
                "failure in a callee signals that the caller can provide "
                "arguments that violate the callee's preconditions."),
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
        )
        attach_issue_annotation(state, issue, self, constraints)
        return [issue]
