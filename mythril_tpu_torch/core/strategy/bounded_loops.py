"""Bounded-loops strategy decorator (API parity:
mythril/laser/ethereum/strategy/extensions/bounded_loops.py:27 — trace-hash loop
counting, prunes JUMPI targets above the loop bound).

Unroll budgets are PER NATURAL LOOP where the static loop table
(staticanalysis/summary.py via module_screen.loop_header_at) knows one:
every arrival at a loop's header pc draws from that loop's budget, so a
loop with several back edges no longer multiplies the global bound by
its edge count. States materialized from the device frontier inside a
loop (parallel/frontier.py LoopHintAnnotation) seed that loop's count
at 1 — the device already spent at least one unroll on them. JUMPDESTs
outside any recovered loop keep the reference's per-(source, target)
edge counting as the fallback. Where the value-range pass proved an
exact trip count (staticanalysis/absint.py, via
cfa_screen.loop_bound_at) that bound replaces the flat default for the
loop — a counting loop unrolls exactly as far as it provably runs.

The port's copy of mythril_tpu/core/strategy/bounded_loops.py."""

from __future__ import annotations

import logging
import sys
from typing import Dict, Set

from ..state.annotation import StateAnnotation
from ..state.global_state import GlobalState
from .basic import BasicSearchStrategy

log = logging.getLogger(__name__)


class JumpdestCountAnnotation(StateAnnotation):
    """Tracks executed (source, target) jump pairs and per-loop-header
    unroll counts per path (header counts use negative keys, so the two
    families can never collide in the one dict)."""

    def __init__(self):
        self._reached_count: Dict[int, int] = {}
        #: loop headers whose count was seeded from a device LoopHint
        self._seeded_headers: Set[int] = set()

    def __copy__(self):
        clone = JumpdestCountAnnotation()
        clone._reached_count = dict(self._reached_count)
        clone._seeded_headers = set(self._seeded_headers)
        return clone


def _loop_hint_headers(state: GlobalState) -> tuple:
    """Header pcs of the LoopHintAnnotations riding on a device-
    materialized state. The annotation class lives in the frontier
    module; if that was never imported, no state can carry one."""
    frontier = sys.modules.get("mythril_tpu_torch.parallel.frontier")
    if frontier is None:
        return ()
    return tuple(hint.header_pc for hint
                 in state.get_annotations(frontier.LoopHintAnnotation))


class BoundedLoopsStrategy(BasicSearchStrategy):
    """Wraps another strategy; drops states that exhaust a loop's unroll
    budget (decorator pattern, reference svm.py:148). `loop_bound` is
    the budget of EACH recovered natural loop — and of each (source,
    target) edge where static loop recovery has no verdict."""

    def __init__(self, super_strategy: BasicSearchStrategy, **kwargs):
        self.super_strategy = super_strategy
        self.bound = kwargs.get("loop_bound", 3)
        super().__init__(super_strategy.work_list, super_strategy.max_depth)

    def calculate_hash(self, address: int, target: int) -> int:
        return address * 2 ** 32 + target

    def __next__(self) -> GlobalState:
        while True:
            state = self.super_strategy.__next__()
            opcode = state.get_current_instruction()["opcode"]
            if opcode != "JUMPDEST":
                return state
            annotations = list(state.get_annotations(JumpdestCountAnnotation))
            if not annotations:
                annotation = JumpdestCountAnnotation()
                state.annotate(annotation)
            else:
                annotation = annotations[0]
            address = state.get_current_instruction()["address"]
            header = None
            try:
                from ...analysis import module_screen

                header = module_screen.loop_header_at(
                    state.environment.code, address)
            except Exception:  # no static tables for this code object
                header = None
            bound = self.bound
            if header == address:
                # a statically proven trip count replaces the flat
                # default for THIS loop: the interval prover counted
                # header arrivals to the exit, which is exactly what
                # this strategy counts (absint.loop_bounds_applied)
                try:
                    from ...smt.solver import cfa_screen

                    proven = cfa_screen.loop_bound_at(
                        state.environment.code, header)
                except Exception:
                    proven = None
                if proven is not None:
                    bound = max(1, proven)
                # one arrival at the header = one unroll of THIS loop,
                # whichever back edge (or the entry edge) got us here
                key = -header - 1
                if header not in annotation._seeded_headers:
                    annotation._seeded_headers.add(header)
                    if header in _loop_hint_headers(state):
                        # materialized mid-loop: the device frontier
                        # already spent at least one unroll
                        annotation._reached_count[key] = \
                            annotation._reached_count.get(key, 0) + 1
            else:
                source = state.mstate.prev_pc
                key = self.calculate_hash(source, address)
            annotation._reached_count[key] = \
                annotation._reached_count.get(key, 0) + 1
            if annotation._reached_count[key] > bound:
                log.debug("loop bound %d exceeded at %d", bound, address)
                continue
            return state
