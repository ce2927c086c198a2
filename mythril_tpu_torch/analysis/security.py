"""Analysis orchestration: run detection modules (API parity:
mythril/analysis/security.py — fire_lasers:28, retrieve_callback_issues:14).

The port's copy of mythril_tpu/analysis/security.py."""

from __future__ import annotations

import logging
from typing import List, Optional

from .module import ModuleLoader, get_detection_module_hooks
from .module.base import EntryPoint
from .report import Issue

log = logging.getLogger(__name__)


def retrieve_callback_issues(white_list: Optional[List[str]] = None) -> List[Issue]:
    """Harvest issues accumulated by CALLBACK modules during exploration."""
    issues: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
            entry_point=EntryPoint.CALLBACK, white_list=white_list):
        issues.extend(module.issues)
    reset_callback_modules(white_list)
    return issues


def reset_callback_modules(white_list: Optional[List[str]] = None) -> None:
    for module in ModuleLoader().get_detection_modules(
            entry_point=EntryPoint.CALLBACK, white_list=white_list):
        module.reset_module()


def fire_lasers(statespace, white_list: Optional[List[str]] = None) -> List[Issue]:
    """Run POST modules over the statespace and merge CALLBACK results."""
    issues: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
            entry_point=EntryPoint.POST, white_list=white_list):
        log.info("executing %s", module.name)
        result = module.execute(statespace)
        if result:
            issues.extend(result)
    issues.extend(retrieve_callback_issues(white_list))
    for issue in issues:
        issue.resolve_function_name()
    return issues
