"""Ether phishing detection (capability parity:
mythril/analysis/module/modules/ether_phishing.py: a victim (SOMEGUY) transaction
can be tricked into transferring ether to the attacker — phishing via crafted
intermediate contract state).

The port's copy of mythril_tpu/analysis/modules/ether_phishing.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...core.transaction.symbolic import ACTORS
from ...core.transaction.transaction_models import ContractCreationTransaction
from ...smt import UGT
from ..module.base import DetectionModule, EntryPoint
from ..potential_issues import PotentialIssue, get_potential_issues_annotation
from ..swc_data import UNPROTECTED_ETHER_WITHDRAWAL

log = logging.getLogger(__name__)


class EtherPhishing(DetectionModule):
    name = "A victim transaction can be redirected to benefit the attacker"
    swc_id = UNPROTECTED_ETHER_WITHDRAWAL
    description = ("Search for cases where a benign sender's transaction "
                   "profits the attacker (phishing-style withdrawal): the "
                   "attacker sets up state, a victim transaction pays out to "
                   "the attacker.")
    entry_point = EntryPoint.CALLBACK
    post_hooks = ["CALL"]
    taint_sinks = {"CALL": ()}

    def _execute(self, state: GlobalState):
        world_state = state.world_state
        transactions = [t for t in world_state.transaction_sequence
                        if not isinstance(t, ContractCreationTransaction)]
        if len(transactions) < 2:
            return []
        constraints = []
        # attacker sends all but the last tx; the victim (someguy) sends the last
        for transaction in transactions[:-1]:
            constraints.append(transaction.caller == ACTORS.attacker)
            constraints.append(transaction.call_value == 0)
        constraints.append(transactions[-1].caller == ACTORS.someguy)
        constraints.append(UGT(
            world_state.balances[ACTORS.attacker],
            world_state.starting_balances[ACTORS.attacker]))

        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=getattr(state.environment, "active_function_name",
                                  "fallback"),
            address=state.get_current_instruction()["address"] - 1,
            swc_id=self.swc_id,
            title="Ether phishing",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="An attacker can profit from a transaction sent "
                             "by a different user.",
            description_tail=(
                "The attacker can prepare contract state such that a "
                "transaction sent by another (benign) user transfers Ether to "
                "the attacker. This is a phishing-style vulnerability: review "
                "authorization of value transfers and avoid letting one user's "
                "state setup redirect another user's funds."),
            detector=self,
            constraints=constraints,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue)
        return []
