"""SWC-112 Delegatecall to untrusted callee (capability parity:
mythril/analysis/module/modules/delegatecall.py: DELEGATECALL target solvable to an
attacker-chosen address, with calldata-tainted target).

The port's copy of mythril_tpu/analysis/modules/delegatecall.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...core.transaction.symbolic import ACTORS
from ...core.transaction.transaction_models import ContractCreationTransaction
from ...smt import UGT, symbol_factory
from ..module.base import DetectionModule, EntryPoint
from ..potential_issues import PotentialIssue, get_potential_issues_annotation
from ..swc_data import DELEGATECALL_TO_UNTRUSTED_CONTRACT

log = logging.getLogger(__name__)


class ArbitraryDelegateCall(DetectionModule):
    name = "Delegatecall to a user-specified address"
    swc_id = DELEGATECALL_TO_UNTRUSTED_CONTRACT
    description = "Check for invocations of delegatecall to a user-supplied address."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["DELEGATECALL"]
    # presence-only: a deterministic `to` equal to the attacker actor
    # address would still satisfy the module's constraints
    taint_sinks = {"DELEGATECALL": ()}

    def _execute(self, state: GlobalState):
        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]
        if to.raw.is_const:
            return []  # fixed library target: fine

        constraints = [
            to == ACTORS.attacker,
            # enough gas forwarded for meaningful reentry, and the call must
            # succeed (reference delegatecall.py:49-57)
            UGT(gas, symbol_factory.BitVecVal(2300, 256)),
            state.new_bitvec(
                f"retval_{state.get_current_instruction()['address']}",
                256) == 1,
            *[transaction.caller == ACTORS.attacker
              for transaction in state.world_state.transaction_sequence
              if not isinstance(transaction, ContractCreationTransaction)],
        ]
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=getattr(state.environment, "active_function_name",
                                  "fallback"),
            address=state.get_current_instruction()["address"],
            swc_id=self.swc_id,
            title="Delegatecall to user-supplied address",
            bytecode=state.environment.code.bytecode,
            severity="High",
            description_head="The contract delegates execution to another "
                             "contract with a user-supplied address.",
            description_tail=(
                "The smart contract delegates execution to a user-supplied "
                "address. This could allow an attacker to execute arbitrary code "
                "in the context of this contract account and manipulate the "
                "state of the contract account or execute actions on its "
                "behalf."),
            detector=self,
            constraints=constraints,
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue)
        return []
