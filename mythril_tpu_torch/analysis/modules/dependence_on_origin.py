"""SWC-115 tx.origin authorization (capability parity:
mythril/analysis/module/modules/dependence_on_origin.py: ORIGIN value flowing into
a JUMPI condition — traced through expression taint annotations).

The port's copy of mythril_tpu/analysis/modules/dependence_on_origin.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import TX_ORIGIN_USAGE

log = logging.getLogger(__name__)


class OriginAnnotation:
    """Taint marker placed on the ORIGIN value."""


class TxOrigin(DetectionModule):
    name = "Control flow depends on tx.origin"
    swc_id = TX_ORIGIN_USAGE
    description = ("Check whether control flow decisions are influenced by "
                   "tx.origin.")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]
    post_hooks = ["ORIGIN"]
    taint_sinks = {"ORIGIN": ()}

    def _execute(self, state: GlobalState):
        instruction = state.get_current_instruction()
        if instruction["opcode"] != "JUMPI":
            # ORIGIN post-hook (fires on the successor state): taint the pushed value
            state.mstate.stack[-1].annotate(OriginAnnotation())
            return []

        # JUMPI pre-hook: condition is the second stack item
        condition = state.mstate.stack[-2]
        if not any(isinstance(annotation, OriginAnnotation)
                   for annotation in condition.annotations):
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
            title="Dependence on tx.origin",
            severity="Low",
            description_head="Use of tx.origin as a part of authorization control.",
            description_tail=(
                "The tx.origin environment variable has been found to influence "
                "a control flow decision. Note that using tx.origin as a security "
                "control might cause a vulnerability where a malicious contract "
                "can trick users into performing sensitive actions. Consider "
                "using msg.sender instead."),
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
        )
        attach_issue_annotation(state, issue, self, constraints)
        return [issue]
