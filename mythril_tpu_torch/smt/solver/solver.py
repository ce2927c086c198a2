"""check-sat / model engines (API parity: mythril/laser/smt/solver/solver.py —
BaseSolver:18, Solver:103, Optimize:122).

Where the reference calls into z3, this drives the owned pipeline:
constraints -> preprocess.lower_constraints (arrays/UFs -> QF_BV)
            -> bitblast.Blaster (QF_BV -> CNF)
            -> sat.solve_cnf (native CDCL, Python fallback)
            -> Model reconstruction (bits -> ints, Ackermann records -> array/UF tables).

Optimize implements minimize/maximize by bounded binary search over repeated
check-sat calls — witness minimization parity for get_transaction_sequence
(reference analysis/solver.py:219) without an OMT engine.

The port's copy of mythril_tpu/smt/solver/solver.py on the host CDCL, with
two differences:

- `--solver jax` goes through the batch dispatch (the JAX package's
  smt/solver/dispatch.py), which is not ported yet (ROADMAP A 10). With
  `args.solver == "jax"`, `check_formulas`, `check_formulas_oneshot`,
  `_solve_backend` and `prefetch_formulas` raise NotImplementedError; they
  never answer on the CDCL in the device lane's place.
- The JAX package takes its one-shot route (re-lower and re-blast every
  query) only when the native core is missing. The port always has its
  CDCL (a failed build raises), so `check_formulas` always runs the
  incremental pipeline and the one-shot route is `check_formulas_oneshot`.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

log = logging.getLogger(__name__)

from .. import terms
from ..model import Model
from .bitblast import Blaster
from .preprocess import lower_constraints
from . import sat
from .solver_statistics import SolverStatistics, stat_smt_query

#: why the device lane raises, until ROADMAP A 10 ports it
DEVICE_LANE_MISSING = (
    "--solver jax runs through the batch dispatch (mythril_tpu/smt/solver/"
    "dispatch.py), which mythril_tpu_torch has not ported yet: ROADMAP A 10")


def require_host_solver() -> None:
    """Raise NotImplementedError when `args.solver` asks for the device
    lane: the port answers only on the host CDCL until A 10."""
    from ...support.support_args import args

    if args.solver == "jax":
        raise NotImplementedError(DEVICE_LANE_MISSING)


#: conflict budget used when a caller gives a millisecond timeout; measured on this
#: host a conflict averages ~1-3us in the native core, so 25_000ms ~ 4M conflicts.
CONFLICTS_PER_MS = 160


def _model_satisfies(clauses, model) -> bool:
    """Cheap host-side verification of a SAT model: every clause must have a
    true literal under the assignment (model[v-1] is DIMACS var v)."""
    for clause in clauses:
        for lit in clause:
            value = model[lit - 1] if lit > 0 else not model[-lit - 1]
            if value:
                break
        else:
            return False
    return True


def _crosscheck_device_verdict(clauses, n_vars, max_conflicts, status, model):
    """Divergence quarantine (opt-in, `--device-crosscheck N`): re-decide a
    sampled device verdict on the host — SAT models are verified directly
    against the clauses, UNSAT claims replayed through the host CDCL oracle.
    Any disagreement QUARANTINEs the device backend for the rest of the run
    and the host's answer is returned instead. Returns (status, model)."""
    from ...support import resilience

    statistics = SolverStatistics()
    injected = resilience.take("divergence")
    every = resilience.crosscheck_every()
    if not injected:
        if not every or (statistics.device_solved + 1) % every != 0:
            return status, model
    else:
        # simulate a wrong device verdict so the oracle path is exercised
        # end-to-end: flip sat<->unsat (a bogus model would also be caught
        # by the clause check below)
        status = sat.UNSAT if status == sat.SAT else sat.SAT
        model = None if status == sat.UNSAT else [False] * n_vars

    statistics.crosschecks += 1
    diverged = None  # detail string when the device verdict is disproven
    host_status, host_model = status, model
    if status == sat.SAT:
        if model is None or not _model_satisfies(clauses, model):
            diverged = "device SAT model does not satisfy the clauses"
            host_status, host_model = sat.solve_cnf(clauses, n_vars,
                                                    max_conflicts)
    else:  # UNSAT claim: replay through the host oracle
        host_status, host_model = sat.solve_cnf(clauses, n_vars,
                                                max_conflicts)
        if host_status == sat.SAT:
            diverged = "device claimed UNSAT but host oracle found a model"
        elif host_status == sat.UNKNOWN:
            # oracle inconclusive: cannot confirm or refute — keep device
            host_status, host_model = status, model

    if diverged is None:
        return host_status, host_model
    statistics.divergences += 1
    log.critical("device/host verdict DIVERGENCE on %d clauses / %d vars: "
                 "%s — quarantining the device backend", len(clauses),
                 n_vars, diverged)
    resilience.registry.backend(resilience.DEVICE).record_failure(
        resilience.DIVERGENCE, diverged)
    return host_status, host_model


def prefetch_formulas(constraint_sets, max_conflicts: int = 2_000_000) -> int:
    """Speculatively queue the device cones of several independent
    constraint sets on the batch dispatch queue (the `--solver jax` lane).
    The host CDCL has no queue, so nothing is queued and this returns 0;
    under `--solver jax` it raises until ROADMAP A 10 ports the dispatch."""
    require_host_solver()
    return 0


def _solve_backend(clauses, n_vars, max_conflicts, timeout_ms=0):
    """Route to the configured SAT backend (one-shot, non-incremental path)."""
    require_host_solver()
    return sat.solve_cnf(clauses, n_vars, max_conflicts, timeout_ms)


#: process-wide incremental pipeline (persistent blast pool + CDCL session);
#: None until first use, recreated when its pool outgrows RESET_VAR_LIMIT
_pipeline = None


def _get_pipeline():
    global _pipeline
    if _pipeline is not None and _pipeline.needs_reset:
        _pipeline.close()
        _pipeline = None
    if _pipeline is None:
        from .incremental import IncrementalPipeline

        _pipeline = IncrementalPipeline()
    return _pipeline


def reset_solver_backend() -> None:
    """Drop the process-wide incremental pipeline and the model caches.

    Per-query cost grows with the monotone pool (the session re-propagates
    its whole trail); a fresh analysis — or a test that asserts exact
    sat/unsat behavior — can call this to shed state accumulated by earlier
    heavy workloads. (The JAX package also resets its dispatch queue here,
    which the port does not have yet.)"""
    global _pipeline
    if _pipeline is not None:
        _pipeline.close()
        _pipeline = None
    from ...support import model as model_service

    model_service.reset_model_caches()
    # a PREVIOUS analysis's expired global clock must not clamp fresh
    # queries to a ~0ms solver budget (get_model enforces
    # time_handler.time_remaining; the singleton outlives the analysis
    # that started it, so standalone is_possible() calls after an analysis
    # silently reported sat queries as impossible)
    from ...core.time_handler import time_handler

    time_handler.reset()
    # fresh backends + disarmed fault plan: breaker trips and quarantines
    # belong to the analysis that suffered them, not the next one
    from ...support import resilience

    resilience.reset()


def _prepass(raw_constraints: List[terms.Term]):
    """The shared front of both routes: constant constraints, then the
    word-level simplification. Returns (verdict, None) when that decides the
    query, else (None, the constraints left to solve)."""
    pending = []
    for constraint in raw_constraints:
        if constraint is terms.TRUE:
            continue
        if constraint is terms.FALSE:
            return ("unsat", None), None
        pending.append(constraint)
    if not pending:
        return ("sat", Model()), None

    # word-level simplification before any lowering/blasting — shared by the
    # incremental, one-shot and device paths (simplify.py; memoized, so the
    # get_model funnel's repeated tuples cost one pass)
    from ...support.support_args import args as support_args

    if getattr(support_args, "simplify", True):
        from .simplify import simplify_constraints

        outcome = simplify_constraints(pending)
        if outcome.is_false:
            return ("unsat", None), None
        pending = outcome.constraints
        if not pending:
            return ("sat", Model()), None
    return None, pending


def check_formulas(raw_constraints: List[terms.Term],
                   max_conflicts: int = 2_000_000,
                   timeout_ms: int = 0) -> Tuple[str, Optional[Model]]:
    """The core decision procedure. Returns ("sat"|"unsat"|"unknown", model).
    timeout_ms > 0 enforces a wall-clock deadline inside the native solver
    (reference analogue: the get_model watchdog, support/model.py:104-119)."""
    require_host_solver()
    decided, pending = _prepass(raw_constraints)
    if decided is not None:
        return decided
    return _get_pipeline().check(pending, max_conflicts,
                                 timeout_ms=timeout_ms)


def check_formulas_oneshot(raw_constraints: List[terms.Term],
                           max_conflicts: int = 2_000_000,
                           timeout_ms: int = 0
                           ) -> Tuple[str, Optional[Model]]:
    """check_formulas without the incremental pipeline: re-lower and
    re-blast the query from scratch and solve it with `sat.solve_cnf` (the
    JAX package's route when it has no native build)."""
    require_host_solver()
    decided, pending = _prepass(raw_constraints)
    if decided is not None:
        return decided
    # already simplified above, so lower raw here
    lowered, info = lower_constraints(pending, simplify=False)
    blaster = Blaster()
    for constraint in lowered:
        blaster.assert_true(constraint)
    SolverStatistics().last_query_clauses = len(blaster.clauses)
    status, sat_model = _solve_backend(blaster.clauses, blaster.n_vars,
                                       max_conflicts, timeout_ms)
    if status == sat.UNSAT:
        return "unsat", None
    if status == sat.UNKNOWN:
        return "unknown", None

    model = Model()
    for var_term, bits in blaster.var_bits.items():
        value = 0
        for position, lit in enumerate(bits):
            bit = sat_model[lit - 1] if lit > 0 else not sat_model[-lit - 1]
            if bit:
                value |= 1 << position
        model.assignment[var_term] = value
    for var_term, lit in blaster.var_lits.items():
        model.assignment[var_term] = (sat_model[lit - 1] if lit > 0
                                      else not sat_model[-lit - 1])
    # rebuild array tables from Ackermann read records
    for base, index, fresh in info.array_reads:
        index_value = model.eval(index)
        model.arrays.setdefault(base, {})[index_value] = model.assignment.get(fresh, 0)
    for name, args, fresh in info.uf_applications:
        arg_values = tuple(model.eval(a) for a in args)
        model.ufs[(name, arg_values)] = model.assignment.get(fresh, 0)
    return "sat", model


class BaseSolver:
    def __init__(self, timeout: Optional[int] = None):
        self.constraints: List = []
        self.timeout = timeout  # milliseconds
        self._model: Optional[Model] = None
        self._scopes: List[int] = []

    def set_timeout(self, timeout: int) -> None:
        self.timeout = timeout

    def add(self, *constraints) -> None:
        for constraint in constraints:
            if isinstance(constraint, (list, tuple)):
                self.constraints.extend(constraint)
            else:
                self.constraints.append(constraint)

    append = add

    def _budget(self) -> int:
        if self.timeout is None:
            return 2_000_000
        return max(10_000, self.timeout * CONFLICTS_PER_MS)

    @stat_smt_query
    def check(self, *extra) -> str:
        raw = [c.raw for c in list(self.constraints) + list(extra)]
        status, model = check_formulas(raw, self._budget(),
                                       timeout_ms=self.timeout or 0)
        self._model = model
        return status

    def model(self) -> Optional[Model]:
        return self._model

    def sexpr(self) -> str:
        from ..smtlib import to_smt2

        return to_smt2([c.raw for c in self.constraints])

    def reset(self) -> None:
        self.constraints = []
        self._model = None
        self._scopes = []

    def push(self) -> None:
        """Open a constraint scope (real scoping — with the incremental
        backend, push/pop is just list bookkeeping; the blast pool and the
        CDCL session persist regardless)."""
        self._scopes.append(len(self.constraints))

    def pop(self) -> None:
        """Drop constraints added since the matching push (full reset when no
        scope is open, preserving the reference's z3 pop-to-empty habit)."""
        if self._scopes:
            del self.constraints[self._scopes.pop():]
            self._model = None
        else:
            self.reset()


class Solver(BaseSolver):
    """Plain check-sat solver (reference smt/solver/solver.py:103)."""


class Optimize(BaseSolver):
    """check-sat + objective minimization/maximization via bounded binary search."""

    def __init__(self, timeout: Optional[int] = None):
        super().__init__(timeout)
        self._objectives: List[Tuple[object, bool]] = []  # (BitVec, minimize?)

    def minimize(self, expression) -> None:
        self._objectives.append((expression, True))

    def maximize(self, expression) -> None:
        self._objectives.append((expression, False))

    @stat_smt_query
    def check(self, *extra) -> str:
        base = list(self.constraints) + list(extra)
        raw = [c.raw for c in base]
        status, model = check_formulas(raw, self._budget())
        if status != "sat" or not self._objectives:
            self._model = model
            return status

        # the probe loop may not outlive the GLOBAL execution budget: the
        # base check above already consumed per-query time, and un-clamped
        # probes were the corpus overrun (runs measured at 1.2-2.3x their
        # wall budget, VERDICT r4 weak #3)
        from ...core.time_handler import time_handler

        probe_ms = self.timeout if self.timeout else 10_000.0
        remaining_ms = time_handler.time_remaining() - 500
        if remaining_ms < probe_ms:
            probe_ms = max(remaining_ms, 1)  # expired budget: no probing
        deadline = time.time() + probe_ms / 1000.0

        def probe_budget():
            left = int((deadline - time.time()) * 1000)
            budget = self._budget()
            return min(budget, max(left, 1)) if budget else max(left, 1)

        # speculative extreme-probe prefetch (`--solver jax` + batching):
        # witness minimization usually drives every objective straight to
        # its extreme (value and calldatasize minimize to 0), so queue the
        # whole extreme-probe ladder on the dispatch queue now — the first
        # probe's check flushes them as ONE device batch, and the later
        # probes hit the verdict cache instead of launching again
        speculative = []
        spec_bounds: List[terms.Term] = []
        for objective, is_minimize in self._objectives:
            obj_raw = objective.raw
            width = obj_raw.width
            extreme_value = 0 if is_minimize else (1 << width) - 1
            pin = terms.bv_cmp("eq", obj_raw,
                               terms.bv_const(extreme_value, width))
            speculative.append(raw + spec_bounds + [pin])
            spec_bounds.append(pin)
        prefetch_formulas(speculative, self._budget())

        bound_terms: List[terms.Term] = []
        for objective, is_minimize in self._objectives:
            obj_raw = objective.raw
            width = obj_raw.width
            best = model.eval(obj_raw)
            low, high = (0, best) if is_minimize else (best, (1 << width) - 1)
            # probe the extreme first: minimized witnesses are usually 0 (value,
            # calldatasize) and maximized ones usually hit the range bound, so
            # one probe typically closes the whole search
            if low < high:
                extreme = low if is_minimize else high
                probe = terms.bv_cmp("eq", obj_raw, terms.bv_const(extreme, width))
                probe_status, probe_model = check_formulas(
                    raw + bound_terms + [probe], probe_budget())
                if probe_status == "sat":
                    model = probe_model
                    low = high = extreme
            while low < high and time.time() < deadline:
                mid = (low + high) // 2 if is_minimize else (low + high + 1) // 2
                if is_minimize:
                    probe = terms.bv_cmp("bvule", obj_raw, terms.bv_const(mid, width))
                else:
                    probe = terms.bv_cmp("bvule", terms.bv_const(mid, width), obj_raw)
                probe_status, probe_model = check_formulas(
                    raw + bound_terms + [probe], probe_budget())
                if probe_status == "sat":
                    model = probe_model
                    value = probe_model.eval(obj_raw)
                    if is_minimize:
                        high = min(value, mid)
                    else:
                        low = max(value, mid)
                elif probe_status == "unsat":
                    if is_minimize:
                        low = mid + 1
                    else:
                        high = mid - 1
                else:
                    # "unknown" teaches nothing: narrowing on it would
                    # mislabel a reachable optimum as excluded — keep the
                    # best model found and stop searching this objective
                    break
            # pin the reached optimum so later objectives respect earlier ones
            final = model.eval(obj_raw)
            bound_terms.append(terms.bv_cmp("eq", obj_raw,
                                            terms.bv_const(final, width)))
        self._model = model
        return "sat"
