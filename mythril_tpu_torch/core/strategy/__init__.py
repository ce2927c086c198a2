"""The port's copy of mythril_tpu/core/strategy/__init__.py.
`ConcolicStrategy` is left out until ROADMAP A 6b.3 (it needs
`analysis.solver`)."""

from .basic import (BasicSearchStrategy, BreadthFirstSearchStrategy,
                    DepthFirstSearchStrategy, ReturnRandomNaivelyStrategy,
                    ReturnWeightedRandomStrategy)
from .beam import BeamSearch
from .constraint_strategy import DelayConstraintStrategy
from .bounded_loops import BoundedLoopsStrategy

__all__ = [
    "BasicSearchStrategy", "DepthFirstSearchStrategy", "BreadthFirstSearchStrategy",
    "ReturnRandomNaivelyStrategy", "ReturnWeightedRandomStrategy", "BeamSearch",
    "DelayConstraintStrategy", "BoundedLoopsStrategy",
]
