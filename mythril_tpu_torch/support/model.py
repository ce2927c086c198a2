"""The single funnel for all satisfiability checks (API parity:
mythril/support/model.py — get_model:69 with global model LRU + ModelCache quick-sat
pre-check + timeout conversion to UnsatError/SolverTimeOutException).

Performance note: the quick-sat pre-check re-evaluates cached models against the new
constraint set with the term evaluator (cheap, pure Python) before paying for a
bit-blast + CDCL run; the overwhelming majority of engine-issued checks hit this
path. This is also where `--solver jax` batches sat-checks on TPU.

The port's copy of mythril_tpu/support/model.py. Its device prefetch
(`prefetch_models`) queues nothing on the host CDCL, and under `--solver jax`
it raises as the solver does until ROADMAP A 10 ports the batch dispatch."""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Iterable, Optional, Tuple

from ..exceptions import SolverTimeOutException, UnsatError
from ..smt import Bool, Model, Optimize, Solver, terms
from ..smt.solver.solver_statistics import SolverStatistics
from ..core.time_handler import time_handler
from .support_args import args


class LRUCache:
    def __init__(self, size: int):
        self.size = size
        self._cache: OrderedDict = OrderedDict()

    def get(self, key):
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        return None

    def put(self, key, value) -> None:
        self._cache[key] = value
        self._cache.move_to_end(key)
        if len(self._cache) > self.size:
            self._cache.popitem(last=False)

    def __len__(self):
        return len(self._cache)


class ModelCache:
    """Keeps recent sat models; `check_quick_sat` re-evaluates them against a new
    constraint conjunction (reference support/support_utils.py:56-66)."""

    def __init__(self, size: int = 32):
        self.model_cache = LRUCache(size)

    def put(self, model: Model, weight: int = 1) -> None:
        self.model_cache.put(model, weight)

    def check_quick_sat(self, constraints: Iterable[terms.Term]) -> Optional[Model]:
        constraints = list(constraints)
        for model in list(self.model_cache._cache.keys()):
            try:
                if all(model.eval(c) for c in constraints):
                    self.model_cache.put(model, 1)
                    return model
            except (KeyError, ValueError, TypeError):
                # the probe is best-effort: KeyError = the model lacks a
                # variable this conjunction mentions; ValueError/TypeError =
                # the evaluator met a term it cannot fold. Anything else is
                # a real bug and must surface.
                continue
        return None


model_cache = ModelCache()

#: query-result cache keyed by the constraint tuple (terms are hash-consed)
_result_cache = LRUCache(2 ** 16)


def reset_model_caches() -> None:
    """Drop the sat-model reuse cache and the query-result cache (used by
    solver.reset_solver_backend; results cached against a now-discarded
    pipeline's models must not leak into a fresh one)."""
    global model_cache, _result_cache
    model_cache = ModelCache()
    _result_cache = LRUCache(2 ** 16)

#: zero model tried first: most path constraints are satisfied by all-zeros
_ZERO_MODEL = Model()


def prefetch_models(constraint_tuples: Iterable[Tuple]) -> int:
    """Speculatively queue device SAT work for several upcoming get_model
    calls (`--solver jax` + batching only; a cheap no-op otherwise). The
    port has no batch dispatch yet: under `--solver jax` with batching on
    this raises NotImplementedError (ROADMAP A 10)."""
    if args.solver == "jax" and getattr(args, "batch_solve", True):
        from ..smt.solver.solver import DEVICE_LANE_MISSING

        raise NotImplementedError(DEVICE_LANE_MISSING)
    return 0


def get_model(constraints, minimize: Tuple = (), maximize: Tuple = (),
              enforce_execution_time: bool = True,
              solver_timeout: Optional[int] = None) -> Model:
    """check-sat with caching; raises UnsatError / SolverTimeOutException."""
    constraints = tuple(constraints)
    simple = not minimize and not maximize

    raw_constraints = []
    for constraint in constraints:
        raw = constraint.raw if isinstance(constraint, Bool) else constraint
        if raw is terms.FALSE:
            raise UnsatError("constant-false constraint")
        if raw is not terms.TRUE:
            raw_constraints.append(raw)

    # cache on the word-level simplified form: syntactically different
    # constraint sets that rewrite to the same conjuncts (constant-prop,
    # keccak/ite/select collapse) share one result-cache entry, and the
    # simplifier's own memo makes the re-simplification in check_formulas
    # free. Quick-sat also evaluates the (usually much smaller) simplified
    # conjunction. Defining equalities are kept by the pass, so a cached
    # model still covers every variable the caller will ask about.
    if getattr(args, "simplify", True):
        from ..smt.solver.simplify import simplify_constraints

        outcome = simplify_constraints(raw_constraints)
        if outcome.is_false:
            raise UnsatError("simplified to false")
        raw_constraints = outcome.constraints

    cache_key = tuple(raw_constraints)
    if simple:
        cached = _result_cache.get(cache_key)
        if cached is not None:
            if cached == "unsat":
                raise UnsatError("cached unsat")
            return cached
        # quick-sat: all-zeros, then recently seen models
        try:
            if all(_ZERO_MODEL.eval(c) for c in raw_constraints):
                return _ZERO_MODEL
        except (KeyError, ValueError, TypeError):
            pass  # zero probe failed to evaluate: fall through to the solver
        hit = model_cache.check_quick_sat(raw_constraints)
        if hit is not None:
            return hit

    timeout = solver_timeout or args.solver_timeout
    if enforce_execution_time:
        timeout = min(timeout, time_handler.time_remaining() - 500)
        if timeout <= 0:
            raise SolverTimeOutException("global execution budget exhausted")

    if simple:
        solver = Solver(timeout=timeout)
    else:
        solver = Optimize(timeout=timeout)
        for expression in minimize:
            solver.minimize(expression)
        for expression in maximize:
            solver.maximize(expression)

    wrapped = [c if isinstance(c, Bool) else Bool(c) for c in raw_constraints]
    solver.add(*wrapped)
    _dump_query(wrapped)
    status = solver.check()
    if status == "sat":
        model = solver.model()
        if simple:
            _result_cache.put(cache_key, model)
            model_cache.put(model)
        return model
    if status == "unknown":
        raise SolverTimeOutException("solver query exceeded budget")
    if simple:
        _result_cache.put(cache_key, "unsat")
    raise UnsatError("unsat")


_query_counter = [0]


def _dump_query(constraints) -> None:
    """--solver-log: dump each query as .smt2 (reference support/model.py:51-61)."""
    if not args.solver_log:
        return
    from ..smt.smtlib import to_smt2

    os.makedirs(args.solver_log, exist_ok=True)
    _query_counter[0] += 1
    # pid-namespaced so successive runs into one directory never overwrite
    path = os.path.join(args.solver_log,
                        f"{os.getpid()}-{_query_counter[0]}.smt2")
    with open(path, "w") as handle:
        handle.write(to_smt2([c.raw for c in constraints]))
