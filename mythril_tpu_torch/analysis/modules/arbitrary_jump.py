"""SWC-127 Arbitrary jump (capability parity:
mythril/analysis/module/modules/arbitrary_jump.py: JUMP destination is symbolic and
attacker-influenceable).

The port's copy of mythril_tpu/analysis/modules/arbitrary_jump.py."""

from __future__ import annotations

import logging

from ...core.state.global_state import GlobalState
from ...exceptions import UnsatError
from ...smt.solver import cfa_screen
from ...support.model import get_model
from ..issue_annotation import attach_issue_annotation
from ..module.base import DetectionModule, EntryPoint
from ..report import Issue
from ..solver import get_transaction_sequence
from ..swc_data import ARBITRARY_JUMP

log = logging.getLogger(__name__)


class ArbitraryJump(DetectionModule):
    name = "Caller can redirect execution to arbitrary bytecode locations"
    swc_id = ARBITRARY_JUMP
    description = "Check for jumps to arbitrary locations in the bytecode"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMP", "JUMPI"]
    # an untainted dest is a deterministic function of the bytecode: on a
    # per-path engine it reaches the hook as a concrete value, and the
    # is_const early-return above fires — skipping the hook is
    # detection-identical, so operand-level screening is sound here
    taint_sinks = {"JUMP": (0,), "JUMPI": (0,)}

    def _execute(self, state: GlobalState):
        jump_dest = state.mstate.stack[-1]
        if jump_dest.raw.is_const:
            return []
        # CFA-resolved site: the dataflow pinned every feasible target
        # statically, so a <=1-target site is structurally not
        # attacker-steerable — skip the two _is_unique_jumpdest solver
        # queries it would otherwise take to prove that
        targets = cfa_screen.resolved_jump_targets(
            state.environment.code,
            state.get_current_instruction()["address"])
        if targets is not None and len(targets) <= 1:
            return []
        if self._is_unique_jumpdest(jump_dest, state):
            # symbolic but pinned to one feasible value: not attacker-steerable
            # (reference arbitrary_jump.py:22-44)
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
            address=state.get_current_instruction()["address"],
            swc_id=self.swc_id,
            title="Jump to an arbitrary instruction",
            severity="High",
            bytecode=state.environment.code.bytecode,
            description_head="The caller can redirect execution to arbitrary "
                             "bytecode locations.",
            description_tail=(
                "It is possible to redirect the control flow to arbitrary "
                "locations in the code. This may allow an attacker to bypass "
                "security controls or manipulate the business logic of the "
                "smart contract. Avoid using low-level-operations and "
                "assembly to prevent this issue."),
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            transaction_sequence=transaction_sequence,
        )
        attach_issue_annotation(state, issue, self, constraints)
        return [issue]

    @staticmethod
    def _is_unique_jumpdest(jump_dest, state: GlobalState) -> bool:
        """True when the symbolic destination admits exactly one model."""
        try:
            model = get_model(tuple(
                state.world_state.constraints.get_all_constraints()))
            concrete_dest = model.eval(jump_dest.raw)
            get_model(tuple(
                state.world_state.constraints.get_all_constraints()
                + [jump_dest != concrete_dest]))
        except UnsatError:
            return True  # no second value exists
        except Exception:
            return True  # solver timeout: do not report on uncertainty
        return False
