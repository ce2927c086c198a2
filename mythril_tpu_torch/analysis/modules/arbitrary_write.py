"""SWC-124 Write to arbitrary storage (capability parity:
mythril/analysis/module/modules/arbitrary_write.py: SSTORE key fully
attacker-controllable).

The port's copy of mythril_tpu/analysis/modules/arbitrary_write.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...smt import symbol_factory
from ..module.base import DetectionModule, EntryPoint
from ..potential_issues import PotentialIssue, get_potential_issues_annotation
from ..swc_data import WRITE_TO_ARBITRARY_STORAGE

log = logging.getLogger(__name__)


class ArbitraryStorage(DetectionModule):
    name = "Caller can write to arbitrary storage locations"
    swc_id = WRITE_TO_ARBITRARY_STORAGE
    description = "Check for writes to arbitrary storage locations"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SSTORE"]
    # presence-only: a deterministic slot equal to the probe constant
    # would still satisfy `write_slot == probe`, so skipping untainted
    # sites could drop a PotentialIssue the unscreened run reports
    taint_sinks = {"SSTORE": ()}

    def _execute(self, state: GlobalState):
        write_slot = state.mstate.stack[-1]
        if write_slot.raw.is_const:
            return []
        # a CONCRETE improbable probe slot (reference arbitrary_write.py:56):
        # a fresh symbolic probe would be trivially satisfiable for any
        # symbolic key and would report every symbolic write
        probe = symbol_factory.BitVecVal(324345425435, 256)
        potential_issue = PotentialIssue(
            contract=state.environment.active_account.contract_name,
            function_name=getattr(state.environment, "active_function_name",
                                  "fallback"),
            address=state.get_current_instruction()["address"],
            swc_id=self.swc_id,
            title="Write to an arbitrary storage location",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="The caller can write to arbitrary storage "
                             "locations.",
            description_tail=(
                "It is possible to write to arbitrary storage locations. By "
                "modifying the values of storage variables, attackers may bypass "
                "security controls or manipulate the business logic of the smart "
                "contract."),
            detector=self,
            constraints=[write_slot == probe],
        )
        get_potential_issues_annotation(state).potential_issues.append(
            potential_issue)
        return []
