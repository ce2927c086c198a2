"""Two-phase issue flow (capability parity: mythril/analysis/potential_issues.py —
PotentialIssue:11, check_potential_issues:82).

CALLBACK detectors record PotentialIssues with unsolved constraints on the state's
annotations; when a transaction ends, check_potential_issues re-solves them against
the final world-state constraints and promotes survivors to real Issues with
concrete witnesses.

The port's copy of mythril_tpu/analysis/potential_issues.py."""

from __future__ import annotations

from ..core.state.annotation import StateAnnotation
from ..core.state.global_state import GlobalState
from ..exceptions import UnsatError
from ..support.support_args import args
from ..utils.helpers import get_code_hash
from .issue_annotation import attach_issue_annotation
from .report import Issue
from .solver import get_transaction_sequence


class PotentialIssue:
    def __init__(self, contract, function_name, address, swc_id, title, bytecode,
                 detector, severity: str = "Medium", description_head: str = "",
                 description_tail: str = "", constraints=None):
        self.title = title
        self.contract = contract
        self.function_name = function_name
        self.address = address
        self.description_head = description_head
        self.description_tail = description_tail
        self.severity = severity
        self.swc_id = swc_id
        self.bytecode = bytecode
        self.constraints = constraints or []
        self.detector = detector


class PotentialIssuesAnnotation(StateAnnotation):
    def __init__(self):
        self.potential_issues = []

    @property
    def search_importance(self):
        return 10 * len(self.potential_issues)

    def __copy__(self):
        # shared across forks intentionally? No: each path tracks its own
        result = PotentialIssuesAnnotation()
        result.potential_issues = list(self.potential_issues)
        return result


def get_potential_issues_annotation(state: GlobalState) -> PotentialIssuesAnnotation:
    for annotation in state.annotations:
        if isinstance(annotation, PotentialIssuesAnnotation):
            return annotation
    annotation = PotentialIssuesAnnotation()
    state.annotate(annotation)
    return annotation


def check_potential_issues(state: GlobalState) -> None:
    """Re-check recorded potential issues at transaction end
    (called from svm transaction_end hook wiring in analysis/symbolic.py)."""
    annotation = get_potential_issues_annotation(state)
    unsat_issues = []
    for potential_issue in annotation.potential_issues:
        try:
            transaction_sequence = get_transaction_sequence(
                state,
                state.world_state.constraints + potential_issue.constraints)
        except UnsatError:
            unsat_issues.append(potential_issue)
            continue
        issue = Issue(
            contract=potential_issue.contract,
            function_name=potential_issue.function_name,
            address=potential_issue.address,
            title=potential_issue.title,
            bytecode=potential_issue.bytecode,
            swc_id=potential_issue.swc_id,
            gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            description_head=potential_issue.description_head,
            description_tail=potential_issue.description_tail,
            severity=potential_issue.severity,
            transaction_sequence=transaction_sequence,
        )
        attach_issue_annotation(
            state, issue, potential_issue.detector,
            list(state.world_state.constraints) + list(potential_issue.constraints))
        # deferred mode (--enable-summaries): the summary plugin promotes
        # validated annotations instead (reference potential_issues.py:123-125)
        if not args.use_issue_annotations:
            potential_issue.detector.issues.append(issue)
            potential_issue.detector.cache.add(
                (potential_issue.address,
                 get_code_hash(potential_issue.bytecode)))
    annotation.potential_issues = unsat_issues
