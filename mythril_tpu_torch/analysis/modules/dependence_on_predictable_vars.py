"""SWC-116/120 block-value dependence (capability parity:
mythril/analysis/module/modules/dependence_on_predictable_vars.py: TIMESTAMP /
NUMBER / PREVRANDAO / COINBASE / GASLIMIT values influencing a control flow
decision, and BLOCKHASH of a predictable (older) block number).

The port's copy of
mythril_tpu/analysis/modules/dependence_on_predictable_vars.py."""

from __future__ import annotations

import logging

from ...core.state.annotation import StateAnnotation
from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ...smt import ULT, symbol_factory
from ...support.model import get_model
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS

log = logging.getLogger(__name__)

PREDICTABLE_OPS = ["TIMESTAMP", "NUMBER", "COINBASE", "GASLIMIT", "PREVRANDAO",
                   "DIFFICULTY"]


class PredictableValueAnnotation:
    """Expression marker: value derives from a predictable block attribute."""

    def __init__(self, operation: str):
        self.operation = operation


class OldBlockNumberUsedAnnotation(StateAnnotation):
    """State marker: BLOCKHASH was invoked with a provably older block number
    (reference dependence_on_predictable_vars.py:40)."""

    def __copy__(self):
        return OldBlockNumberUsedAnnotation()


class PredictableVariables(DetectionModule):
    name = "Control flow depends on a predictable environment variable"
    swc_id = f"{TIMESTAMP_DEPENDENCE}, {WEAK_RANDOMNESS}"
    description = ("Check whether control flow decisions are influenced by block "
                   "attributes (block.number, block.timestamp, block.prevrandao, "
                   "coinbase, gaslimit) or blockhash.")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI", "BLOCKHASH"]
    post_hooks = PREDICTABLE_OPS + ["BLOCKHASH"]
    taint_sinks = {"BLOCKHASH": (), "JUMPI": ()}

    def _execute(self, state: GlobalState):
        instruction = state.get_current_instruction()
        opcode = instruction["opcode"]

        if opcode == "JUMPI":
            # pre-hook: report every predictable value feeding the condition
            issues = []
            for marker in [a for a in state.mstate.stack[-2].annotations
                           if isinstance(a, PredictableValueAnnotation)]:
                constraints = state.world_state.constraints.get_all_constraints()
                try:
                    transaction_sequence = get_transaction_sequence(
                        state, constraints)
                except UnsatError:
                    continue
                operation = marker.operation
                swc_id = (TIMESTAMP_DEPENDENCE if "timestamp" in operation
                          else WEAK_RANDOMNESS)
                issue = Issue(
                    contract=state.environment.active_account.contract_name,
                    function_name=getattr(state.environment,
                                          "active_function_name", "fallback"),
                    address=instruction["address"],
                    swc_id=swc_id,
                    bytecode=state.environment.code.bytecode,
                    title="Dependence on predictable environment variable",
                    severity="Low",
                    description_head=f"A control flow decision is made based "
                                     f"on {operation}.",
                    description_tail=(
                        f"{operation} is used to determine a control flow "
                        "decision. Note that the values of variables like "
                        "coinbase, gaslimit, block number and timestamp are "
                        "predictable and can be manipulated by a malicious "
                        "miner. Also keep in mind that attackers know hashes "
                        "of earlier blocks. Don't use any of those environment "
                        "variables as sources of randomness and be aware that "
                        "use of these variables introduces a certain level of "
                        "trust into miners."),
                    gas_used=(state.mstate.min_gas_used,
                              state.mstate.max_gas_used),
                    transaction_sequence=transaction_sequence,
                )
                attach_issue_annotation(state, issue, self, constraints)
                issues.append(issue)
            return issues

        if opcode == "BLOCKHASH":
            # pre-hook: can the argument be an OLDER block number?
            param = state.mstate.stack[-1]
            block_number = state.environment.block_number
            try:
                get_model(tuple(
                    state.world_state.constraints.get_all_constraints() + [
                        ULT(param, block_number),
                        # bound so the comparison cannot be satisfied by wrap
                        ULT(block_number,
                            symbol_factory.BitVecVal(2 ** 255, 256)),
                    ]))
                state.annotate(OldBlockNumberUsedAnnotation())
            except Exception:
                pass
            return []

        # post-hooks (successor state): the producing instruction is previous
        producer = state.environment.code.instruction_list[
            state.mstate.pc - 1].op_code
        if producer == "BLOCKHASH":
            if list(state.get_annotations(OldBlockNumberUsedAnnotation)):
                state.mstate.stack[-1].annotate(PredictableValueAnnotation(
                    "The block hash of a previous block"))
            return []
        operation = ("block.timestamp" if producer == "TIMESTAMP"
                     else f"block.{producer.lower()}")
        state.mstate.stack[-1].annotate(PredictableValueAnnotation(operation))
        return []
