"""SWC-101 Integer overflow/underflow (capability parity:
mythril/analysis/module/modules/integer.py).

Mechanism (value-flow precise, as in the reference): source handlers annotate an
operand wrapper with the overflow condition — annotation union through every
subsequent operation carries the marker to all derived values. Sink handlers
(SSTORE value, JUMPI condition, CALL value, RETURNed memory) harvest markers from
the value that actually reaches them into a state-level annotation; at transaction
end each harvested overflow condition is solved together with the final path
constraints and surviving ones become Issues anchored at the arithmetic site.

The port's copy of mythril_tpu/analysis/modules/integer.py."""

from __future__ import annotations

import logging
from typing import List, Set

from ...core.state.annotation import StateAnnotation
from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ...smt import (BVAddNoOverflow, BVMulNoOverflow, BVSubNoUnderflow,
                    Expression, Not, UGT, symbol_factory)
from ...support.model import get_model
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..issue_annotation import attach_issue_annotation
from ..solver import get_transaction_sequence
from ..swc_data import INTEGER_OVERFLOW_AND_UNDERFLOW

log = logging.getLogger(__name__)


class OverUnderflowAnnotation:
    """Rides on expression wrappers from the arithmetic site to the sinks."""

    __slots__ = ("overflowing_state", "operator", "constraint")

    def __init__(self, overflowing_state: GlobalState, operator: str, constraint):
        self.overflowing_state = overflowing_state
        self.operator = operator
        self.constraint = constraint

    def __deepcopy__(self, memo):
        return self


class OverUnderflowStateAnnotation(StateAnnotation):
    """State-level set of markers whose values reached a sink on this path."""

    def __init__(self):
        self.overflowing_state_annotations: Set[OverUnderflowAnnotation] = set()

    def __copy__(self):
        result = OverUnderflowStateAnnotation()
        result.overflowing_state_annotations = set(
            self.overflowing_state_annotations)
        return result


def _get_state_annotation(state: GlobalState) -> OverUnderflowStateAnnotation:
    for annotation in state.annotations:
        if isinstance(annotation, OverUnderflowStateAnnotation):
            return annotation
    annotation = OverUnderflowStateAnnotation()
    state.annotate(annotation)
    return annotation


class IntegerArithmetics(DetectionModule):
    name = "Integer overflow or underflow"
    swc_id = INTEGER_OVERFLOW_AND_UNDERFLOW
    description = ("For every potential overflow/underflow in ADD/SUB/MUL/EXP, "
                   "check whether the corrupted value reaches a sink "
                   "(storage write, branch, call value, return data).")
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["ADD", "SUB", "MUL", "EXP", "SSTORE", "JUMPI", "CALL",
                 "RETURN", "STOP"]
    taint_sinks = {"ADD": (), "SUB": (), "MUL": (), "EXP": ()}

    def __init__(self):
        super().__init__()
        self._ostates_satisfiable: Set[int] = set()
        self._ostates_unsatisfiable: Set[int] = set()

    def reset_module(self):
        super().reset_module()
        self._ostates_satisfiable = set()
        self._ostates_unsatisfiable = set()

    def _execute(self, state: GlobalState) -> List[Issue]:
        opcode = state.get_current_instruction()["opcode"]
        handlers = {
            "ADD": [self._handle_add],
            "SUB": [self._handle_sub],
            "MUL": [self._handle_mul],
            "EXP": [self._handle_exp],
            "SSTORE": [self._handle_sstore],
            "JUMPI": [self._handle_jumpi],
            "CALL": [self._handle_call],
            "RETURN": [self._handle_return, self._handle_transaction_end],
            "STOP": [self._handle_transaction_end],
        }
        issues: List[Issue] = []
        for handler in handlers[opcode]:
            result = handler(state)
            if result:
                issues.extend(result)
        return issues

    # -- sources: annotate an operand so the marker propagates to the result --------
    @staticmethod
    def _operands(state: GlobalState):
        return state.mstate.stack[-1], state.mstate.stack[-2]

    def _annotate_operand(self, state, operand, operator, condition) -> None:
        operand.annotate(OverUnderflowAnnotation(state, operator, condition))

    def _handle_add(self, state: GlobalState):
        a, b = self._operands(state)
        if a.raw.is_const and b.raw.is_const:
            return
        self._annotate_operand(state, a, "addition",
                               Not(BVAddNoOverflow(a, b, False)))

    def _handle_sub(self, state: GlobalState):
        a, b = self._operands(state)
        if a.raw.is_const and b.raw.is_const:
            return
        self._annotate_operand(state, a, "subtraction",
                               Not(BVSubNoUnderflow(a, b, False)))

    def _handle_mul(self, state: GlobalState):
        a, b = self._operands(state)
        if a.raw.is_const and b.raw.is_const:
            return
        if (a.raw.is_const and a.value < 2) or (b.raw.is_const and b.value < 2):
            return
        self._annotate_operand(state, a, "multiplication",
                               Not(BVMulNoOverflow(a, b, False)))

    def _handle_exp(self, state: GlobalState):
        base, exponent = self._operands(state)
        if base.raw.is_const and exponent.raw.is_const:
            return
        if base.raw.is_const and base.value < 2:
            return
        self._annotate_operand(state, base, "exponentiation",
                               UGT(exponent, symbol_factory.BitVecVal(255, 256)))

    # -- sinks: harvest markers from the value that reaches them --------------------
    @staticmethod
    def _harvest(state: GlobalState, value) -> None:
        if not isinstance(value, Expression):
            return
        container = _get_state_annotation(state)
        for annotation in value.annotations:
            if isinstance(annotation, OverUnderflowAnnotation):
                container.overflowing_state_annotations.add(annotation)

    def _handle_sstore(self, state: GlobalState):
        self._harvest(state, state.mstate.stack[-2])

    def _handle_jumpi(self, state: GlobalState):
        self._harvest(state, state.mstate.stack[-2])

    def _handle_call(self, state: GlobalState):
        self._harvest(state, state.mstate.stack[-3])

    def _handle_return(self, state: GlobalState):
        offset, length = state.mstate.stack[-1], state.mstate.stack[-2]
        if not (offset.raw.is_const and length.raw.is_const):
            return
        for element in state.mstate.memory[
                offset.value:offset.value + min(length.value, 320)]:
            self._harvest(state, element)

    # -- resolution at transaction end ----------------------------------------------

    def _handle_transaction_end(self, state: GlobalState) -> List[Issue]:
        issues: List[Issue] = []
        container = _get_state_annotation(state)
        for annotation in container.overflowing_state_annotations:
            ostate = annotation.overflowing_state
            ostate_key = id(ostate)
            if ostate_key in self._ostates_unsatisfiable:
                continue
            if ostate_key not in self._ostates_satisfiable:
                try:
                    get_model(tuple(
                        ostate.world_state.constraints.get_all_constraints()
                        + [annotation.constraint]))
                    self._ostates_satisfiable.add(ostate_key)
                except Exception:
                    self._ostates_unsatisfiable.add(ostate_key)
                    continue
            constraints = (state.world_state.constraints.get_all_constraints()
                           + [annotation.constraint])
            try:
                transaction_sequence = get_transaction_sequence(
                    state, constraints)
            except UnsatError:
                continue
            issue = Issue(
                contract=ostate.environment.active_account.contract_name,
                function_name=getattr(ostate.environment,
                                      "active_function_name", "fallback"),
                address=ostate.get_current_instruction()["address"],
                swc_id=self.swc_id,
                bytecode=ostate.environment.code.bytecode,
                title="Integer Arithmetic Bugs",
                severity="High",
                description_head="The arithmetic operator can {}.".format(
                    "underflow" if annotation.operator == "subtraction"
                    else "overflow"),
                description_tail=(
                    "It is possible to cause an integer overflow or underflow "
                    "in the arithmetic operation. Prevent this by constraining "
                    "inputs using the require() statement or use checked "
                    "arithmetic (Solidity >= 0.8 / SafeMath). Refer to the "
                    "transaction trace generated for this issue to reproduce "
                    "it."),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
            attach_issue_annotation(state, issue, self, constraints)
            issues.append(issue)
        return issues


def harvest_values(state, values) -> None:
    """Harvest OverUnderflowAnnotations from `values` into `state`'s
    container — the device frontier's stand-in for the SSTORE/JUMPI sink
    pre-hooks on instructions it executed in the fused loop
    (parallel/frontier.py materialization). Delegates to the module's own
    sink rule so the two paths cannot diverge."""
    for value in values:
        IntegerArithmetics._harvest(state, value)
