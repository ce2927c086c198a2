"""SWC-106 Unprotected SELFDESTRUCT (capability parity:
mythril/analysis/module/modules/suicide.py — constrain the kill to be triggerable
by an arbitrary attacker, with optional beneficiary==attacker strengthening).

The port's copy of mythril_tpu/analysis/modules/suicide.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...core.transaction.symbolic import ACTORS
from ...core.transaction.transaction_models import ContractCreationTransaction
from ...exceptions import UnsatError
from ...smt import And
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import UNPROTECTED_SELFDESTRUCT

log = logging.getLogger(__name__)


class AccidentallyKillable(DetectionModule):
    name = "Contract can be accidentally killed by anyone"
    swc_id = UNPROTECTED_SELFDESTRUCT
    description = ("Check if the contact can be 'accidentally' killed by anyone. "
                   "For kill-able contracts, also check whether it is possible to "
                   "direct the contract balance to the attacker.")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SELFDESTRUCT"]
    taint_sinks = {"SELFDESTRUCT": ()}

    def _execute(self, state: GlobalState):
        instruction = state.get_current_instruction()
        to = state.mstate.stack[-1]

        log.debug("SELFDESTRUCT found at pc %d", instruction["address"])

        # Only attacker-triggerable kills count: every tx in the sequence must be
        # sendable by the attacker directly — caller == origin suppresses
        # contract-mediated false positives (reference suicide.py:66-69).
        attacker_constraints = []
        for transaction in state.world_state.transaction_sequence:
            if not isinstance(transaction, ContractCreationTransaction):
                attacker_constraints.append(And(
                    transaction.caller == ACTORS.attacker,
                    transaction.caller == transaction.origin))
        base = state.world_state.constraints.get_all_constraints()

        description_head = "Any sender can cause the contract to self-destruct."
        try:
            try:
                constraints = base + attacker_constraints + [to == ACTORS.attacker]
                transaction_sequence = get_transaction_sequence(
                    state, constraints)
                description_tail = (
                    "Any sender can trigger execution of the SELFDESTRUCT "
                    "instruction to destroy this contract account and withdraw "
                    "its balance to an arbitrary address. Review the transaction "
                    "trace generated for this issue and make sure that "
                    "appropriate security controls are in place to prevent "
                    "unrestricted access.")
            except UnsatError:
                constraints = base + attacker_constraints
                transaction_sequence = get_transaction_sequence(
                    state, constraints)
                description_tail = (
                    "Any sender can trigger execution of the SELFDESTRUCT "
                    "instruction to destroy this contract account. Review the "
                    "transaction trace generated for this issue and make sure "
                    "that appropriate security controls are in place to prevent "
                    "unrestricted access.")
            issue = Issue(
                contract=state.environment.active_account.contract_name,
                function_name=getattr(state.environment, "active_function_name",
                                      "fallback"),
                address=instruction["address"],
                swc_id=self.swc_id,
                bytecode=state.environment.code.bytecode,
                title="Unprotected Selfdestruct",
                severity="High",
                description_head=description_head,
                description_tail=description_tail,
                transaction_sequence=transaction_sequence,
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            )
            attach_issue_annotation(state, issue, self, constraints)
            return [issue]
        except UnsatError:
            log.debug("no model found for killable path")
        return []
