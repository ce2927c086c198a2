"""IssueAnnotation (API parity: mythril/analysis/issue_annotation.py:9): ties an
Issue to the conditions under which it fired. Every detector attaches one per
issue (reference modules do the same); with `--enable-summaries`
(args.use_issue_annotations) the annotations replace direct issue emission and
are re-validated when a summary is recorded or replayed.

The port's copy of mythril_tpu/analysis/issue_annotation.py."""

from __future__ import annotations

from typing import List

from ..core.state.annotation import StateAnnotation
from ..smt import And, Bool


class IssueAnnotation(StateAnnotation):
    def __init__(self, conditions: List[Bool], issue, detector):
        self.conditions = conditions
        self.issue = issue
        self.detector = detector

    @property
    def persist_to_world_state(self) -> bool:
        return True

    def __copy__(self):
        return IssueAnnotation(list(self.conditions), self.issue, self.detector)


def attach_issue_annotation(state, issue, detector, constraints) -> None:
    """Annotate the state with the proven condition set for `issue`
    (reference modules attach IssueAnnotation(conditions=[And(*constraints)])
    at every emission site, e.g. suicide.py:114)."""
    state.annotate(IssueAnnotation(
        conditions=[And(*constraints)], issue=issue, detector=detector))
