"""Search strategies = iterator policy over the engine worklist (API parity:
mythril/laser/ethereum/strategy/__init__.py:6-33 + strategy/basic.py).

On the TPU path the analogous decision is which lanes fill the next StateBatch
(parallel/frontier.py); these host-side strategies drive the oracle interpreter.

The port's copy of mythril_tpu/core/strategy/basic.py."""

from __future__ import annotations

import random
from typing import List

from ..state.global_state import GlobalState


class BasicSearchStrategy:
    def __init__(self, work_list: List[GlobalState], max_depth: int, **kwargs):
        self.work_list = work_list
        self.max_depth = max_depth

    def __iter__(self):
        return self

    def get_strategic_global_state(self) -> GlobalState:
        raise NotImplementedError

    def run_check(self) -> bool:
        return True

    def __next__(self) -> GlobalState:
        while True:
            if not self.work_list:
                raise StopIteration
            global_state = self.get_strategic_global_state()
            if global_state.mstate.depth >= self.max_depth:
                continue
            return global_state


class DepthFirstSearchStrategy(BasicSearchStrategy):
    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop()


class BreadthFirstSearchStrategy(BasicSearchStrategy):
    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop(0)


class ReturnRandomNaivelyStrategy(BasicSearchStrategy):
    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop(random.randrange(len(self.work_list)))


class ReturnWeightedRandomStrategy(BasicSearchStrategy):
    """Probability weighted by 1/(depth+1) — shallow states preferred."""

    def get_strategic_global_state(self) -> GlobalState:
        weights = [1.0 / (1 + state.mstate.depth) for state in self.work_list]
        index = random.choices(range(len(self.work_list)), weights=weights)[0]
        return self.work_list.pop(index)
