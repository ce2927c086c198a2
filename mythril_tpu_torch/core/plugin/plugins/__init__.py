"""The port's copy of mythril_tpu/core/plugin/plugins/__init__.py."""

from .mutation_pruner import MutationPrunerBuilder
from .dependency_pruner import DependencyPrunerBuilder
from .call_depth_limiter import CallDepthLimitBuilder
from .coverage import CoveragePluginBuilder
from .coverage_metrics import CoverageMetricsPluginBuilder
from .instruction_profiler import InstructionProfilerBuilder
from .benchmark import BenchmarkPluginBuilder
from .trace import TraceFinderBuilder
from .state_merge import StateMergePluginBuilder

__all__ = [
    "MutationPrunerBuilder", "DependencyPrunerBuilder", "CallDepthLimitBuilder",
    "CoveragePluginBuilder", "CoverageMetricsPluginBuilder",
    "InstructionProfilerBuilder", "BenchmarkPluginBuilder", "TraceFinderBuilder",
    "StateMergePluginBuilder",
]
