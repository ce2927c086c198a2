"""The port's copy of mythril_tpu/analysis/module/__init__.py."""

from .base import DetectionModule, EntryPoint
from .loader import ModuleLoader
from .util import get_detection_module_hooks, reset_callback_modules

__all__ = ["DetectionModule", "EntryPoint", "ModuleLoader",
           "get_detection_module_hooks", "reset_callback_modules"]
