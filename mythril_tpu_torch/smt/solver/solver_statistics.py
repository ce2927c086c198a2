"""Per-process solver query statistics: the port's copy of
mythril_tpu/smt/solver/solver_statistics.py.

A facade over the port's typed metrics registry (observe/metrics.py), as
the JAX package's is over its own: every scalar field in FACADE_METRICS
is a property whose value lives in the registry under a declared metric
name, so ``stats.query_count += 1`` and ``metrics.value("solver.queries")``
are one number. The port's own two counters (PORT_COUNTERS), which the
reference registry does not declare, are plain attributes. Container-
shaped state (failure_counts, batch_bucket_shapes, backends_quarantined)
stays on the instance.
"""

from __future__ import annotations

import time
from functools import wraps

from ...observe import metrics

#: scalar field -> declared metric (observe/metrics.py REGISTRY); these
#: become facade properties on SolverStatistics below
FACADE_METRICS = {
    "query_count": "solver.queries",
    "solver_time": "solver.time",
    "device_queries": "solver.device.queries",
    "device_solved": "solver.device.solved",
    "device_fallbacks": "solver.device.fallbacks",
    #: CNF size of the most recent blasted query (one-shot: full blast;
    #: incremental: clauses shipped for that check) — lets tests pin the
    #: post-simplification clause count of a specific query
    "last_query_clauses": "solver.last_query_clauses",
    # word-level simplification pass (smt/solver/simplify.py)
    "simplify_time": "simplify.time",
    "simplify_iterations": "simplify.iterations",
    "simplify_rewrites": "simplify.rewrites",
    "simplify_constants_propagated": "simplify.const_props",
    "simplify_keccak_rewrites": "simplify.keccak_rewrites",
    "simplify_ite_collapses": "simplify.ite_collapses",
    "simplify_selects_bounded": "simplify.selects_bounded",
    "simplify_extract_fusions": "simplify.extract_fusions",
    "simplify_clauses_avoided": "simplify.clauses_avoided",
    # failure domains + circuit breaker (support/resilience.py)
    "device_skipped": "resilience.device_skipped",
    "breaker_trips": "resilience.breaker_trips",
    "breaker_recoveries": "resilience.breaker_recoveries",
    "crosschecks": "resilience.crosschecks",
    "divergences": "resilience.divergences",
    # batched device dispatch (smt/solver/dispatch.py)
    "batch_submitted": "dispatch.submitted",
    "batch_cache_hits": "dispatch.cache_hits",
    "batch_dedup_hits": "dispatch.dedup_hits",
    "batch_flushes": "dispatch.flushes",
    "batch_flushed_queries": "dispatch.flushed_queries",
    "batch_device_time": "dispatch.device_time",
}

#: the port's own counters, plain attributes: host-oracle SAT answers
#: whose assignment failed the clauses, which the cross-check did not let
#: disprove the device, and of those the ones a second ask (unit clauses
#: first) proved UNSAT
PORT_COUNTERS = ("oracle_faults", "oracle_confirmed")


class SolverStatistics:
    """Singleton: query count + cumulative wall time, printed per contract."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.enabled = False
            cls._instance.reset()
        return cls._instance

    def _init_containers(self) -> None:
        """The non-scalar state with no metric shape (dict/list/set)."""
        #: classified failures keyed "backend:class" (e.g. "device:device_oom")
        self.failure_counts = {}
        self.backends_quarantined = []
        #: distinct (n_tiles, v1, padded_batch) shapes the batch runner
        #: ran — how many buckets the pow2/pow4 scheme opened
        self.batch_bucket_shapes = set()

    def batch_metrics(self) -> dict:
        """Derived batch-dispatch metrics for reports/bench JSON."""
        flushes = self.batch_flushes
        flushed = self.batch_flushed_queries
        submitted = self.batch_submitted
        return {
            "submitted": submitted,
            "cache_hits": self.batch_cache_hits,
            "dedup_hits": self.batch_dedup_hits,
            "flushes": flushes,
            "flushed_queries": flushed,
            "occupancy": round(flushed / flushes, 2) if flushes else 0.0,
            "cache_hit_rate": round(self.batch_cache_hits / submitted, 3)
            if submitted else 0.0,
            "buckets_compiled": len(self.batch_bucket_shapes),
            "amortized_ms_per_query": round(
                self.batch_device_time * 1000.0 / flushed, 2)
            if flushed else 0.0,
        }

    def reset(self) -> None:
        for metric_name in FACADE_METRICS.values():
            metrics.set_value(metric_name, 0)
        for counter in PORT_COUNTERS:
            setattr(self, counter, 0)
        self._init_containers()

    def __repr__(self):
        out = (f"Solver statistics: query count: {self.query_count}, "
               f"solver time: {self.solver_time:.3f}s")
        if self.device_queries:
            out += (f", device queries: {self.device_queries}"
                    f" (device solved: {self.device_solved}, "
                    f"fallbacks to CDCL: {self.device_fallbacks})")
        if self.simplify_rewrites:
            out += (f", simplify: {self.simplify_rewrites} rewrites in "
                    f"{self.simplify_iterations} iterations "
                    f"({self.simplify_time:.3f}s; "
                    f"{self.simplify_constants_propagated} const-props, "
                    f"{self.simplify_keccak_rewrites} keccak, "
                    f"{self.simplify_ite_collapses} ite-collapses, "
                    f"{self.simplify_selects_bounded} bounded-selects, "
                    f"{self.simplify_extract_fusions} extract/concat, "
                    f"~{self.simplify_clauses_avoided} clauses avoided)")
        if self.batch_submitted:
            batch = self.batch_metrics()
            out += (f", batch dispatch: {batch['submitted']} submitted "
                    f"(cache hit rate: {batch['cache_hit_rate']:.1%}, "
                    f"dedup hits: {batch['dedup_hits']}, "
                    f"occupancy: {batch['occupancy']}/flush over "
                    f"{batch['flushes']} flushes, "
                    f"buckets compiled: {batch['buckets_compiled']}, "
                    f"amortized: {batch['amortized_ms_per_query']} "
                    f"ms/query)")
        if self.failure_counts or self.breaker_trips or self.device_skipped:
            classified = ", ".join(f"{key}={count}" for key, count
                                   in sorted(self.failure_counts.items()))
            out += (f", failures: [{classified}]"
                    f" (breaker trips: {self.breaker_trips}, "
                    f"recoveries: {self.breaker_recoveries}, "
                    f"queries skipped: {self.device_skipped})")
        if self.crosschecks:
            out += (f", crosschecks: {self.crosschecks} "
                    f"(divergences: {self.divergences})")
        if self.backends_quarantined:
            out += f", QUARANTINED backends: {self.backends_quarantined}"
        return out


def _facade_property(metric_name: str) -> property:
    def fget(self):
        return metrics.value(metric_name)

    def fset(self, new_value):
        metrics.set_value(metric_name, new_value)

    return property(fget, fset)


for _field, _metric in FACADE_METRICS.items():
    setattr(SolverStatistics, _field, _facade_property(_metric))
del _field, _metric


def stat_smt_query(func):
    """Times every solver check() (decorator parity with the reference)."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        statistics = SolverStatistics()
        statistics.query_count += 1
        started = time.time()
        try:
            return func(*args, **kwargs)
        finally:
            statistics.solver_time += time.time() - started

    return wrapper
