"""SWC-104 Unchecked call return value (capability parity:
mythril/analysis/module/modules/unchecked_retval.py: retval of CALL never
constrained by a branch before the transaction ends).

The port's copy of mythril_tpu/analysis/modules/unchecked_retval.py."""

from __future__ import annotations

import logging
from typing import List

from ...core.state.annotation import StateAnnotation
from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ...smt import And
from ..issue_annotation import IssueAnnotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import UNCHECKED_RET_VAL

log = logging.getLogger(__name__)


class UncheckedRetvalAnnotation(StateAnnotation):
    def __init__(self):
        self.retvals: List[dict] = []

    def __copy__(self):
        result = UncheckedRetvalAnnotation()
        result.retvals = [dict(entry) for entry in self.retvals]
        return result


class UncheckedRetval(DetectionModule):
    name = "Return value of an external call is not checked"
    swc_id = UNCHECKED_RET_VAL
    description = ("Check whether CALL return value is checked before the "
                   "transaction ends.")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["STOP", "RETURN"]
    post_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]
    taint_sinks = {"CALL": (), "DELEGATECALL": (), "STATICCALL": (),
                   "CALLCODE": ()}

    def _execute(self, state: GlobalState):
        instruction = state.get_current_instruction()
        annotations = list(state.get_annotations(UncheckedRetvalAnnotation))
        if not annotations:
            annotation = UncheckedRetvalAnnotation()
            state.annotate(annotation)
        else:
            annotation = annotations[0]

        if instruction["opcode"] not in ("STOP", "RETURN"):
            # CALL-family post-hook (successor state): record the fresh retval
            retval = state.mstate.stack[-1]
            if retval.raw.is_const:
                return []
            call_address = state.environment.code.instruction_list[
                state.mstate.pc - 1].address
            annotation.retvals.append(
                {"address": call_address, "retval": retval})
            return []

        # STOP/RETURN: a retval is unchecked if BOTH values are still possible
        issues = []
        for entry in annotation.retvals:
            retval = entry["retval"]
            base = state.world_state.constraints.get_all_constraints()
            try:
                get_transaction_sequence(state, base + [retval == 1])
                transaction_sequence = get_transaction_sequence(
                    state, base + [retval == 0])
            except UnsatError:
                continue
            issue = Issue(
                contract=state.environment.active_account.contract_name,
                function_name=getattr(state.environment,
                                      "active_function_name", "fallback"),
                address=entry["address"],
                swc_id=self.swc_id,
                bytecode=state.environment.code.bytecode,
                title="Unchecked return value from external call.",
                severity="Medium",
                description_head="The return value of a message call is not "
                                 "checked.",
                description_tail=(
                    "External calls return a boolean value. If the callee halts "
                    "with an exception, 'false' is returned and execution "
                    "continues in the caller. The caller should check whether "
                    "an exception happened and react accordingly to avoid "
                    "unexpected behavior. For example it is often desirable to "
                    "wrap external calls in require() so the transaction is "
                    "reverted if the call fails."),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
            state.annotate(IssueAnnotation(
                conditions=[And(*(base + [retval == 1])),
                            And(*(base + [retval == 0]))],
                issue=issue, detector=self))
            issues.append(issue)
        return issues
