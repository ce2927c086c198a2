"""Detection-module registry (API parity: mythril/analysis/module/loader.py:37 —
singleton with the 18 built-ins, entry-point and white-list filtering).

The port's copy of mythril_tpu/analysis/module/loader.py."""

from __future__ import annotations

import logging
from typing import List, Optional

from ...exceptions import DetectorNotFoundError
from .base import DetectionModule, EntryPoint

log = logging.getLogger(__name__)


class ModuleLoader:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._modules = []
            cls._instance._register_mythril_modules()
        return cls._instance

    def register_module(self, detection_module: DetectionModule):
        if not isinstance(detection_module, DetectionModule):
            raise ValueError("not a DetectionModule")
        self._modules.append(detection_module)

    def get_detection_modules(self, entry_point: Optional[EntryPoint] = None,
                              white_list: Optional[List[str]] = None
                              ) -> List[DetectionModule]:
        result = self._modules[:]
        if white_list:
            available = {type(module).__name__ for module in result}
            for name in white_list:
                if name not in available:
                    raise DetectorNotFoundError(
                        f"invalid detection module: {name}")
            result = [m for m in result if type(m).__name__ in white_list]
        if entry_point:
            result = [m for m in result if m.entry_point == entry_point]
        return result

    def _register_mythril_modules(self):
        from ..modules import (
            AccidentallyKillable, ArbitraryDelegateCall, ArbitraryJump,
            ArbitraryStorage, EtherThief, EtherPhishing, Exceptions,
            ExternalCalls, IntegerArithmetics, MultipleSends,
            PredictableVariables, RequirementsViolation, StateChangeAfterCall,
            TxOrderDependence, TxOrigin, UncheckedRetval, UnexpectedEther,
            UserAssertions,
        )

        self._modules.extend([
            AccidentallyKillable(), ArbitraryDelegateCall(), ArbitraryJump(),
            ArbitraryStorage(), EtherThief(), EtherPhishing(), Exceptions(),
            ExternalCalls(), IntegerArithmetics(), MultipleSends(),
            PredictableVariables(), RequirementsViolation(),
            StateChangeAfterCall(), TxOrderDependence(), TxOrigin(),
            UncheckedRetval(), UnexpectedEther(), UserAssertions(),
        ])
