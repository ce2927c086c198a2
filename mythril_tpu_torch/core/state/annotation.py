"""State annotations (API parity: mythril/laser/ethereum/state/annotation.py).

Annotations ride on GlobalState/WorldState and are how plugins and detectors attach
per-path metadata. `persist_to_world_state` survives transaction boundaries;
`persist_over_calls` survives message-call frames.

The port's copy of mythril_tpu/core/state/annotation.py."""

from __future__ import annotations


class StateAnnotation:
    @property
    def persist_to_world_state(self) -> bool:
        return False

    @property
    def persist_over_calls(self) -> bool:
        return False

    @property
    def search_importance(self) -> int:
        """Used by the beam search strategy; higher = kept first."""
        return 1


class MergeableStateAnnotation(StateAnnotation):
    """Annotation that knows how to merge with a sibling (state-merge plugin)."""

    def check_merge_annotation(self, other) -> bool:
        raise NotImplementedError

    def merge_annotation(self, other):
        raise NotImplementedError
