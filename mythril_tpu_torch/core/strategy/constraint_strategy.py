"""Delayed-constraint ("pending") strategy (API parity:
mythril/laser/ethereum/strategy/constraint_strategy.py:19).

Defers feasibility checks: states execute optimistically; before dispatch each state
gets a quick-sat check against the model cache and only solver-confirmed-unsat states
are dropped. This is exactly the execution discipline of the TPU lockstep engine
(step optimistically, batch-check every k steps), so this strategy doubles as its
host-side reference semantics.

The port's copy of mythril_tpu/core/strategy/constraint_strategy.py."""

from __future__ import annotations

import logging
from typing import List

from ...exceptions import UnsatError
from ...support.model import get_model
from ..state.global_state import GlobalState
from .basic import BasicSearchStrategy

log = logging.getLogger(__name__)


class DelayConstraintStrategy(BasicSearchStrategy):
    def __init__(self, work_list, max_depth, **kwargs):
        super().__init__(work_list, max_depth)
        self.model_cache_hits = 0
        self.solver_calls = 0

    def get_strategic_global_state(self) -> GlobalState:
        while self.work_list:
            state = self.work_list.pop(0)
            try:
                get_model(tuple(state.world_state.constraints.get_all_constraints()))
                return state
            except UnsatError:
                log.debug("dropping unsat state at depth %d", state.mstate.depth)
                continue
        raise StopIteration

    def __next__(self) -> GlobalState:
        while True:
            if not self.work_list:
                raise StopIteration
            state = self.get_strategic_global_state()
            if state.mstate.depth >= self.max_depth:
                continue
            return state
