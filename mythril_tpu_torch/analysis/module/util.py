"""Hook wiring for CALLBACK detection modules (API parity:
mythril/analysis/module/util.py — get_detection_module_hooks).

The port's copy of mythril_tpu/analysis/module/util.py."""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Callable, Dict, List

from .. import module_screen
from .base import DetectionModule, EntryPoint
from .loader import ModuleLoader

log = logging.getLogger(__name__)


def get_detection_module_hooks(modules: List[DetectionModule],
                               hook_type: str = "pre") -> Dict[str, List[Callable]]:
    hook_dict: Dict[str, List[Callable]] = defaultdict(list)
    for module in modules:
        hooks = module.pre_hooks if hook_type == "pre" else module.post_hooks
        for op_code in hooks:
            def hook_wrapper(module_reference=module, op=op_code):
                if hook_type == "pre":
                    # the taint module screen can prove some sites
                    # issue-free (untainted sink operands) before any
                    # solver query; post hooks fire after the op, where
                    # the summary's site pc no longer lines up
                    def hook(global_state):
                        if module_screen.should_skip_site(
                                module_reference, op, global_state):
                            return
                        module_reference.execute(global_state)
                else:
                    def hook(global_state):
                        module_reference.execute(global_state)

                return hook

            hook_dict[op_code].append(hook_wrapper())
    return dict(hook_dict)


def reset_callback_modules(module_names=(), allow_blank_modules: bool = False) -> None:
    modules = ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=module_names or None)
    for module in modules:
        module.reset_module()
