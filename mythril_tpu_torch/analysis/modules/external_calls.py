"""SWC-107 External call to user-supplied address (capability parity:
mythril/analysis/module/modules/external_calls.py: CALL with
attacker-controlled target and more than stipend gas forwarded => reentrancy
surface; two-phase PotentialIssue flow).

The port's copy of mythril_tpu/analysis/modules/external_calls.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...core.transaction.symbolic import ACTORS
from ...exceptions import UnsatError
from ...smt import UGT, symbol_factory
from ..module.base import DetectionModule, EntryPoint
from ..potential_issues import PotentialIssue, get_potential_issues_annotation
from ..solver import get_transaction_sequence
from ..swc_data import REENTRANCY

log = logging.getLogger(__name__)


class ExternalCalls(DetectionModule):
    name = "External call to another contract"
    swc_id = REENTRANCY
    description = ("Check for external calls with enough forwarded gas for the "
                   "callee to re-enter (reference external_calls.py).")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]
    taint_sinks = {"CALL": ()}

    def _execute(self, state: GlobalState):
        if getattr(state.environment, "active_function_name",
                   "") == "constructor":
            return []

        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]

        # enough gas forwarded for the callee to do damage (the 2300 stipend
        # is reentrancy-safe), target steerable to the attacker
        constraints = [UGT(gas, symbol_factory.BitVecVal(2300, 256)),
                       to == ACTORS.attacker]
        try:
            get_transaction_sequence(
                state,
                state.world_state.constraints.get_all_constraints()
                + constraints)
        except UnsatError:
            return []

        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=getattr(state.environment, "active_function_name",
                                  "fallback"),
            address=state.get_current_instruction()["address"],
            swc_id=self.swc_id,
            title="External Call To User-Supplied Address",
            bytecode=state.environment.code.bytecode,
            severity="Low",
            description_head="A call to a user-supplied address is executed.",
            description_tail=(
                "An external message call to an address specified by the caller "
                "is executed. Note that the callee account might contain "
                "arbitrary code and could re-enter any function within this "
                "contract. Reentering the contract in an intermediate state may "
                "lead to unexpected behaviour. Make sure that no state "
                "modifications are executed after this call and/or reentrancy "
                "guards are in place."),
            constraints=constraints,
            detector=self,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue)
        return []
