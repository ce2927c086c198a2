"""The port's copy of mythril_tpu/core/strategy/__init__.py."""

from .basic import (BasicSearchStrategy, BreadthFirstSearchStrategy,
                    DepthFirstSearchStrategy, ReturnRandomNaivelyStrategy,
                    ReturnWeightedRandomStrategy)
from .beam import BeamSearch
from .constraint_strategy import DelayConstraintStrategy
from .bounded_loops import BoundedLoopsStrategy
from .concolic import ConcolicStrategy

__all__ = [
    "BasicSearchStrategy", "DepthFirstSearchStrategy", "BreadthFirstSearchStrategy",
    "ReturnRandomNaivelyStrategy", "ReturnWeightedRandomStrategy", "BeamSearch",
    "DelayConstraintStrategy", "BoundedLoopsStrategy", "ConcolicStrategy",
]
