"""SWC-114 Transaction order dependence (capability parity:
mythril/analysis/module/modules/transaction_order_dependence.py: the value of
an ether transfer is tainted by BALANCE/SLOAD reads whose writer another
(attacker) transaction could be — front-runnable race; two-phase
PotentialIssue flow).

The port's copy of
mythril_tpu/analysis/modules/transaction_order_dependence.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...core.transaction.symbolic import ACTORS
from ...smt import Or, symbol_factory
from ..module.base import DetectionModule, EntryPoint
from ..potential_issues import PotentialIssue, get_potential_issues_annotation
from ..swc_data import TX_ORDER_DEPENDENCE

log = logging.getLogger(__name__)


class BalanceAnnotation:
    def __init__(self, caller):
        self.caller = caller


class StorageAnnotation:
    def __init__(self, caller):
        self.caller = caller


class TxOrderDependence(DetectionModule):
    name = "Transaction Order Dependence"
    swc_id = TX_ORDER_DEPENDENCE
    description = "Search for calls whose value depends on balance or storage."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]
    post_hooks = ["BALANCE", "SLOAD"]
    taint_sinks = {"CALL": ()}

    @staticmethod
    def _annotate_read(state: GlobalState, opcode: str):
        value = state.mstate.stack[-1]
        annotation_type = (BalanceAnnotation if opcode == "BALANCE"
                           else StorageAnnotation)
        if not list(value.get_annotations(annotation_type)):
            value.annotate(annotation_type(state.environment.sender))
        return []

    def _execute(self, state: GlobalState):
        opcode = state.get_current_instruction()["opcode"]
        if opcode != "CALL":
            opcode = state.environment.code.instruction_list[
                state.mstate.pc - 1].op_code
        if opcode in ("BALANCE", "SLOAD"):
            return self._annotate_read(state, opcode)

        value = state.mstate.stack[-3]
        storage_annotations = list(value.get_annotations(StorageAnnotation))
        balance_annotations = list(value.get_annotations(BalanceAnnotation))
        if not storage_annotations and not balance_annotations:
            return []
        callers = [a.caller for a in storage_annotations[:1]] + \
                  [a.caller for a in balance_annotations[:1]]

        # the competing writer transaction must be attacker-sendable
        call_constraint = symbol_factory.BoolVal(False)
        for caller in callers:
            call_constraint = Or(call_constraint, ACTORS.attacker == caller)

        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=getattr(state.environment, "active_function_name",
                                  "fallback"),
            address=state.get_current_instruction()["address"],
            swc_id=self.swc_id,
            bytecode=state.environment.code.bytecode,
            title="Transaction Order Dependence",
            severity="Medium",
            description_head="The value of the call is dependent on balance "
                             "or storage write",
            description_tail=(
                "This can lead to race conditions. An attacker may be able to "
                "run a transaction after our transaction which can change the "
                "value of the call"),
            detector=self,
            constraints=[call_constraint],
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue)
        return []
