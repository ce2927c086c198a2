"""SWC-113 Multiple external sends in one transaction (capability parity:
mythril/analysis/module/modules/multiple_sends.py: DoS with failed call — a second
external call in the same transaction).

The port's copy of mythril_tpu/analysis/modules/multiple_sends.py."""

from __future__ import annotations

import logging

from ...core.state.annotation import StateAnnotation
from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import MULTIPLE_SENDS

log = logging.getLogger(__name__)


class MultipleSendsAnnotation(StateAnnotation):
    def __init__(self):
        self.call_offsets = []

    def __copy__(self):
        result = MultipleSendsAnnotation()
        result.call_offsets = list(self.call_offsets)
        return result


class MultipleSends(DetectionModule):
    name = "Multiple external calls in the same transaction"
    swc_id = MULTIPLE_SENDS
    description = "Check for multiple sends in a single transaction"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE", "RETURN", "STOP"]
    taint_sinks = {"CALL": (), "DELEGATECALL": (), "STATICCALL": (),
                   "CALLCODE": ()}

    def _execute(self, state: GlobalState):
        annotations = list(state.get_annotations(MultipleSendsAnnotation))
        if not annotations:
            annotation = MultipleSendsAnnotation()
            state.annotate(annotation)
        else:
            annotation = annotations[0]

        instruction = state.get_current_instruction()
        if instruction["opcode"] in ("CALL", "DELEGATECALL", "STATICCALL",
                                     "CALLCODE"):
            annotation.call_offsets.append(instruction["address"])
            return []

        # RETURN/STOP: report if more than one external call happened
        if len(annotation.call_offsets) < 2:
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
            address=annotation.call_offsets[1],
            swc_id=self.swc_id,
            bytecode=state.environment.code.bytecode,
            title="Multiple Calls in a Single Transaction",
            severity="Low",
            description_head="Multiple calls are executed in the same "
                             "transaction.",
            description_tail=(
                "This call is executed following another call within the same "
                "transaction. It is possible that the call never gets executed "
                "if a prior call fails permanently. This might be caused "
                "intentionally by a malicious callee. If possible, refactor the "
                "code such that each transaction only executes one external "
                "call, or make sure that all callees can be trusted (i.e. "
                "they're part of your own codebase)."),
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
        )
        attach_issue_annotation(state, issue, self, constraints)
        return [issue]
