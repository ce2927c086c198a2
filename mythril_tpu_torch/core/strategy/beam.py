"""Beam search over annotation-declared importance (API parity:
mythril/laser/ethereum/strategy/beam.py:7).

The port's copy of mythril_tpu/core/strategy/beam.py."""

from __future__ import annotations

from typing import List

from ..state.global_state import GlobalState
from .basic import BasicSearchStrategy


class BeamSearch(BasicSearchStrategy):
    def __init__(self, work_list, max_depth, beam_width: int = 16, **kwargs):
        super().__init__(work_list, max_depth)
        self.beam_width = beam_width

    @staticmethod
    def beam_priority(state: GlobalState) -> int:
        return sum(annotation.search_importance
                   for annotation in state._annotations)

    def sort_and_eliminate_states(self) -> None:
        self.work_list.sort(key=self.beam_priority, reverse=True)
        del self.work_list[self.beam_width:]

    def get_strategic_global_state(self) -> GlobalState:
        self.sort_and_eliminate_states()
        return self.work_list.pop(0)
