"""SWC-107 State change after external call (capability parity:
mythril/analysis/module/modules/state_change_external_calls.py — record
qualifying external calls, then report any later persistent-state access
(SSTORE/SLOAD/CREATE/CREATE2, or a value-transferring call) on the same
path; two-phase PotentialIssue flow).

The port's copy of
mythril_tpu/analysis/modules/state_change_external_calls.py."""

from __future__ import annotations

import logging
from typing import List, Optional

from ...core.state.annotation import StateAnnotation
from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ...smt import BitVec, Or, UGT, symbol_factory
from ...support.model import get_model
from ..module.base import DetectionModule, EntryPoint
from ..potential_issues import PotentialIssue, get_potential_issues_annotation
from ..solver import get_transaction_sequence
from ..swc_data import REENTRANCY

log = logging.getLogger(__name__)

CALL_LIST = ["CALL", "DELEGATECALL", "CALLCODE"]
STATE_READ_WRITE_LIST = ["SSTORE", "SLOAD", "CREATE", "CREATE2"]

#: probe address for "can the attacker choose the callee"
ATTACKER_PROBE = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF


class StateChangeCallsAnnotation(StateAnnotation):
    def __init__(self, call_state: GlobalState, user_defined_address: bool):
        self.call_state = call_state
        self.state_change_states: List[GlobalState] = []
        self.user_defined_address = user_defined_address

    def __copy__(self):
        result = StateChangeCallsAnnotation(self.call_state,
                                            self.user_defined_address)
        result.state_change_states = list(self.state_change_states)
        return result

    def get_issue(self, global_state: GlobalState,
                  detector: "StateChangeAfterCall") -> Optional[PotentialIssue]:
        if not self.state_change_states:
            return None
        gas = self.call_state.mstate.stack[-1]
        to = self.call_state.mstate.stack[-2]
        constraints = [
            UGT(gas, symbol_factory.BitVecVal(2300, 256)),
            Or(to > symbol_factory.BitVecVal(16, 256),
               to == symbol_factory.BitVecVal(0, 256)),
        ]
        if self.user_defined_address:
            constraints.append(to == ATTACKER_PROBE)
        try:
            get_transaction_sequence(
                global_state,
                global_state.world_state.constraints.get_all_constraints()
                + constraints)
        except UnsatError:
            return None

        severity = "Medium" if self.user_defined_address else "Low"
        read_or_write = "Write to"
        if global_state.get_current_instruction()["opcode"] == "SLOAD":
            read_or_write = "Read of"
        address_type = "user defined" if self.user_defined_address else "fixed"
        return PotentialIssue(
            contract=global_state.environment.active_account.contract_name,
            function_name=getattr(global_state.environment,
                                  "active_function_name", "fallback"),
            address=global_state.get_current_instruction()["address"],
            title="State access after external call",
            severity=severity,
            description_head=f"{read_or_write} persistent state following "
                             f"external call",
            description_tail=(
                f"The contract account state is accessed after an external "
                f"call to a {address_type} address. To prevent reentrancy "
                f"issues, consider accessing the state only before the call, "
                f"especially if the callee is untrusted. Alternatively, a "
                f"reentrancy lock can be used to prevent untrusted callees "
                f"from re-entering the contract in an intermediate state."),
            swc_id=REENTRANCY,
            bytecode=global_state.environment.code.bytecode,
            constraints=constraints,
            detector=detector,
        )


class StateChangeAfterCall(DetectionModule):
    name = "State change after an external call"
    swc_id = REENTRANCY
    description = ("Check whether the account state is accessed after an "
                   "external call to a user-defined address.")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = CALL_LIST + STATE_READ_WRITE_LIST
    taint_sinks = {"CALL": (), "DELEGATECALL": (), "CALLCODE": (),
                   "SSTORE": ()}

    def _execute(self, state: GlobalState):
        if getattr(state.environment, "active_function_name",
                   "") == "constructor":
            return []
        annotations = list(state.get_annotations(StateChangeCallsAnnotation))
        opcode = state.get_current_instruction()["opcode"]

        if not annotations and opcode in STATE_READ_WRITE_LIST:
            return []
        if opcode in STATE_READ_WRITE_LIST:
            for annotation in annotations:
                annotation.state_change_states.append(state)
        if opcode in CALL_LIST:
            # a value transfer is itself a state change on the annotated paths
            # (CALL/CALLCODE only: DELEGATECALL has no value argument —
            # stack[-3] there is the input memory offset)
            if opcode != "DELEGATECALL":
                value: BitVec = state.mstate.stack[-3]
                if self._balance_change(value, state):
                    for annotation in annotations:
                        annotation.state_change_states.append(state)
            self._add_external_call(state)

        potential_issues = []
        for annotation in annotations:
            if not annotation.state_change_states:
                continue
            issue = annotation.get_issue(state, self)
            if issue:
                potential_issues.append(issue)
        get_potential_issues_annotation(state).potential_issues.extend(
            potential_issues)
        return []

    @staticmethod
    def _add_external_call(state: GlobalState) -> None:
        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]
        base = state.world_state.constraints.get_all_constraints()
        try:
            get_model(tuple(base + [
                UGT(gas, symbol_factory.BitVecVal(2300, 256)),
                Or(to > symbol_factory.BitVecVal(16, 256),
                   to == symbol_factory.BitVecVal(0, 256))]))
        except UnsatError:
            return
        except Exception:
            return  # solver timeout
        try:
            get_model(tuple(base + [to == ATTACKER_PROBE]))
            state.annotate(StateChangeCallsAnnotation(state, True))
        except UnsatError:
            state.annotate(StateChangeCallsAnnotation(state, False))
        except Exception:
            state.annotate(StateChangeCallsAnnotation(state, False))

    @staticmethod
    def _balance_change(value: BitVec, state: GlobalState) -> bool:
        if value.raw.is_const:
            return value.raw.value > 0
        try:
            get_model(tuple(
                state.world_state.constraints.get_all_constraints()
                + [UGT(value, symbol_factory.BitVecVal(0, 256))]))
            return True
        except Exception:
            return False
