"""Detection-module framework (API parity: mythril/analysis/module/base.py —
EntryPoint:20, DetectionModule:31 with pre/post hook declarations and the
(address, code_hash)-keyed issue cache).

The port's copy of mythril_tpu/analysis/module/base.py."""

from __future__ import annotations

import logging
from enum import Enum
from typing import Dict, List, Optional, Set, Tuple

from ...core.state.global_state import GlobalState
from ...support.support_args import args
from ...utils.helpers import get_code_hash
from ..report import Issue

log = logging.getLogger(__name__)


class EntryPoint(Enum):
    """POST modules scan the recorded statespace after exploration; CALLBACK
    modules run as SVM opcode hooks during it."""

    POST = 1
    CALLBACK = 2


class DetectionModule:
    name = "detection module"
    swc_id = ""
    description = ""
    entry_point = EntryPoint.CALLBACK
    pre_hooks: List[str] = []
    post_hooks: List[str] = []
    #: sink declaration for the taint module screen
    #: (analysis/module_screen.py): hooked opcode -> operand indices
    #: (0 = top of stack at the hook site) whose untaintedness makes an
    #: issue impossible there. An EMPTY tuple is a presence-only sink:
    #: it documents what the module sinks on but opts out of site-level
    #: screening (the module can flag sites with deterministic operands
    #: too, so skipping on "untainted" would change detections). Only
    #: declare operand indices when `every operand untainted (i.e. a
    #: deterministic function of the bytecode) => _execute returns no
    #: issue` provably holds.
    taint_sinks: Dict[str, Tuple[int, ...]] = {}

    def __init__(self):
        self.issues: List[Issue] = []
        self.cache: Set[Tuple[int, str]] = set()
        self.auto_cache = True

    def reset_module(self) -> None:
        self.issues = []
        # the (address, code_hash) cache must not outlive one analysis: a
        # fresh analysis of the same bytecode would silently report nothing
        self.cache = set()

    def update_cache(self, issues: Optional[List[Issue]] = None) -> None:
        issues = issues if issues is not None else self.issues
        for issue in issues:
            self.cache.add((issue.address, issue.bytecode_hash))

    def execute(self, target: GlobalState) -> Optional[List[Issue]]:
        log.debug("entering module %s", type(self).__name__)
        if self.auto_cache and isinstance(target, GlobalState):
            if self._cache_hit(target):
                return []
        result = self._execute(target)
        if result:
            # in issue-annotation mode (--enable-summaries) issues are deferred:
            # the summary plugin re-validates the attached IssueAnnotations
            # against substituted conditions (reference module/base.py:93)
            if not args.use_issue_annotations:
                self.issues.extend(result)
                self.update_cache(result)
        return result

    def _cache_hit(self, state: GlobalState) -> bool:
        address = state.get_current_instruction()["address"]
        code_hash = get_code_hash(state.environment.code.bytecode)
        return (address, code_hash) in self.cache

    def _execute(self, target) -> Optional[List[Issue]]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return (f"<DetectionModule name={self.name} swc_id={self.swc_id} "
                f"pre_hooks={self.pre_hooks} post_hooks={self.post_hooks}>")
