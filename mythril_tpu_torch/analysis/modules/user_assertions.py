"""SWC-110 user-level assertion reporting (capability parity:
mythril/analysis/module/modules/user_assertions.py — `emit
AssertionFailed(string)` events via LOG1 and the 0xcafecafe... MSTORE
property-check pattern; Panic(uint256) reverts are handled by the
`exceptions` module).

The port's copy of mythril_tpu/analysis/modules/user_assertions.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ...smt import Extract
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import ASSERT_VIOLATION

log = logging.getLogger(__name__)

#: keccak("AssertionFailed(string)")
ASSERTION_FAILED_HASH = \
    0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0

#: MythX-style property-check marker written via MSTORE
MSTORE_PATTERN = "0xcafecafecafecafecafecafecafecafecafecafecafecafecafecafecafe"


def _decode_abi_string(data: list) -> str:
    """Hand-decoded `abi.encode(string)` tail: 32-byte length + bytes."""
    if len(data) < 32:
        return ""
    if not all(b.raw.is_const for b in data[:32]):
        return ""
    length = int.from_bytes(bytes(b.value for b in data[:32]), "big")
    if length > len(data) - 32:
        return ""
    payload = data[32:32 + length]
    if not all(b.raw.is_const for b in payload):
        return ""
    return bytes(b.value for b in payload).decode("utf-8", errors="replace")


class UserAssertions(DetectionModule):
    name = "A user-defined assertion has been triggered"
    swc_id = ASSERT_VIOLATION
    description = ("Search for reachable user-supplied exceptions: "
                   "emit AssertionFailed(string).")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["LOG1", "MSTORE"]
    taint_sinks = {"LOG1": (), "MSTORE": ()}

    def _execute(self, state: GlobalState):
        opcode = state.get_current_instruction()["opcode"]
        message = None
        if opcode == "MSTORE":
            value = state.mstate.stack[-2]
            if not value.raw.is_const:
                return []
            if MSTORE_PATTERN not in hex(value.raw.value)[:126]:
                return []
            message = f"Failed property id {Extract(15, 0, value).raw.value}"
        else:  # LOG1
            topic, size, mem_start = state.mstate.stack[-3:]
            if not topic.raw.is_const or topic.raw.value != ASSERTION_FAILED_HASH:
                return []
            if mem_start.raw.is_const and size.raw.is_const:
                data = state.mstate.memory[
                    mem_start.raw.value + 32:
                    mem_start.raw.value + size.raw.value]
                decoded = _decode_abi_string(data)
                if decoded:
                    message = decoded

        constraints = state.world_state.constraints.get_all_constraints()
        try:
            transaction_sequence = get_transaction_sequence(state, constraints)
        except UnsatError:
            return []
        description_tail = (
            f"A user-provided assertion failed with the message '{message}'"
            if message else "A user-provided assertion failed.")
        issue = Issue(
            contract=state.environment.active_account.contract_name,
            function_name=getattr(state.environment, "active_function_name",
                                  "fallback"),
            address=state.get_current_instruction()["address"],
            swc_id=self.swc_id,
            title="Exception State",
            severity="Medium",
            bytecode=state.environment.code.bytecode,
            description_head="A user-provided assertion failed.",
            description_tail=description_tail,
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
        )
        attach_issue_annotation(state, issue, self, constraints)
        return [issue]
