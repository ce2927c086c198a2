"""SWC-105 Unprotected Ether Withdrawal (capability parity:
mythril/analysis/module/modules/ether_thief.py — two-phase PotentialIssue flow:
attacker ends with more ether than they put in).

The port's copy of mythril_tpu/analysis/modules/ether_thief.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...core.transaction.symbolic import ACTORS
from ...exceptions import SolverTimeOutException, UnsatError
from ...smt import UGT
from ...support.model import get_model
from ..module.base import DetectionModule, EntryPoint
from ..potential_issues import PotentialIssue, get_potential_issues_annotation
from ..swc_data import UNPROTECTED_ETHER_WITHDRAWAL

log = logging.getLogger(__name__)


class EtherThief(DetectionModule):
    name = "Any sender can withdraw ETH from the contract account"
    swc_id = UNPROTECTED_ETHER_WITHDRAWAL
    description = ("Search for cases where Ether can be withdrawn to a "
                   "user-specified address.")
    entry_point = EntryPoint.CALLBACK
    post_hooks = ["CALL", "STATICCALL"]
    taint_sinks = {"CALL": (), "STATICCALL": ()}

    def _execute(self, state: GlobalState):
        # runs right after the CALL's post handler: inspect the completed
        # transfer. Constraint set mirrors reference ether_thief.py:100-112:
        # attacker profits, final tx sent directly by the attacker.
        world_state = state.world_state
        constraints = [
            UGT(world_state.balances[ACTORS.attacker],
                world_state.starting_balances[ACTORS.attacker]),
            state.environment.sender == ACTORS.attacker,
            state.current_transaction.caller == state.current_transaction.origin,
        ]

        # pre-solve so a potential issue is only recorded on feasible profit
        try:
            get_model(tuple(world_state.constraints.get_all_constraints()
                            + constraints))
        except (UnsatError, SolverTimeOutException):
            return []

        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=getattr(state.environment, "active_function_name",
                                  "fallback"),
            address=state.get_current_instruction()["address"] - 1,
            swc_id=self.swc_id,
            title="Unprotected Ether Withdrawal",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="Any sender can withdraw Ether from the contract "
                             "account.",
            description_tail=(
                "Arbitrary senders other than the contract creator can profitably "
                "extract Ether from the contract account. Verify the business "
                "logic carefully and make sure that appropriate security controls "
                "are in place to prevent unexpected loss of funds."),
            detector=self,
            constraints=constraints,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue)
        return []
