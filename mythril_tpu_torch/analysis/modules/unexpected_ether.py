"""SWC-132 Unexpected ether balance (capability parity:
mythril/analysis/module/modules/unexpected_ether.py: strict balance equality used
in a control-flow decision — breakable by force-feeding ether via selfdestruct).

The port's copy of mythril_tpu/analysis/modules/unexpected_ether.py."""

from __future__ import annotations

import logging

from ...core.state.annotation import StateAnnotation
from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import UNEXPECTED_ETHER_BALANCE

log = logging.getLogger(__name__)


class BalanceAnnotation:
    """Marker on values derived from SELFBALANCE/BALANCE(this)."""


class UnexpectedEther(DetectionModule):
    name = "Contract behavior depends on its exact balance"
    swc_id = UNEXPECTED_ETHER_BALANCE
    description = ("Check for strict comparisons on the contract's own balance "
                   "(breakable by force-feeding ether).")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]
    post_hooks = ["BALANCE", "SELFBALANCE"]
    taint_sinks = {"BALANCE": (), "SELFBALANCE": ()}

    def _execute(self, state: GlobalState):
        instruction = state.get_current_instruction()
        if instruction["opcode"] != "JUMPI":
            # BALANCE/SELFBALANCE post-hook (successor state): taint pushed value
            state.mstate.stack[-1].annotate(BalanceAnnotation())
            return []

        condition = state.mstate.stack[-2]
        if not any(isinstance(a, BalanceAnnotation)
                   for a in condition.annotations):
            return []
        # strict equality on balance: an eq term over a balance-tainted value
        if not _contains_strict_equality(condition):
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
            bytecode=state.environment.code.bytecode,
            title="Dependence on the exact contract balance",
            severity="Medium",
            description_head="The contract's behavior depends on its exact "
                             "Ether balance.",
            description_tail=(
                "A control flow decision depends on a strict comparison with "
                "the contract's own balance. Since Ether can be forcibly sent "
                "to any contract (e.g. via selfdestruct or as a coinbase "
                "reward), strict equality checks on the balance can be broken "
                "by an attacker, potentially locking the contract's logic."),
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
        )
        attach_issue_annotation(state, issue, self, constraints)
        return [issue]


def _contains_strict_equality(condition) -> bool:
    from ...smt import terms

    for node in terms.walk(condition.raw):
        if node.op == "eq" and isinstance(node.args[0].sort, int):
            return True
    return False
