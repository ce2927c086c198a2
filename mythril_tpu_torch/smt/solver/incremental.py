"""Incremental decision procedure: persistent bit-blast pool + assumption solving.

The reference leans on z3's incremental solving plus a 2^23-entry model cache
(mythril/support/model.py:69-119); every check here used to re-lower and
re-bit-blast the full constraint set from scratch. This module is the
equivalent lever, built from the parts this framework owns:

- Lowering (arrays/UFs -> QF_BV) runs against *global* registries: the same
  (array, index) read or UF application maps to the same fresh variable in
  every query, so the shared prefix of a growing path condition lowers once.
- The Tseitin Blaster is monotone: structural hashing means a term's gate
  definitions enter the clause pool exactly once; its root literal doubles as
  the *assumption literal* for that constraint (the pool contains only
  definitions — full biconditionals — and valid Ackermann facts, so it is
  always satisfiable; a query is the pool solved under the root literals of
  its constraint set).
- The native CDCL runs as a long-lived session (native/cdcl.cpp
  mtpu_session_*): learned clauses, VSIDS activities and saved phases persist
  across queries.
- Ackermann consistency facts (equal indices -> equal read values; equal args
  -> equal UF results) are valid implications, asserted unconditionally the
  first time a pair of reads co-occurs in a query (matching the per-query
  pairing of the one-shot pipeline in preprocess._add_ackermann).

`--solver jax` rides the same pool: the device DPLL receives
pool-clauses + one unit per assumption literal, with the CDCL session as the
loud fallback (solver.py counts the fallbacks).

The port's copy of mythril_tpu/smt/solver/incremental.py. The device cone's
clause cap is the port's `parallel/device_solver.DEFAULT_CLAUSE_CAP`; the
port's `solver.check_formulas` passes no `device_solve` until the batch
dispatch is ported (ROADMAP A 10), but `check`/`prepare_device_query` keep
the hook and the cone extraction it needs.
"""

from __future__ import annotations

import itertools
import logging
from typing import Dict, FrozenSet, List, Optional, Tuple

log = logging.getLogger(__name__)

from .. import terms
from ..model import Model
from .bitblast import Blaster
from .preprocess import LoweringInfo, _lower, read_pair_fact, uf_pair_fact
from .solver_statistics import SolverStatistics
from . import sat

#: rebuild the pipeline when the pool grows past this many SAT variables
#: (multi-hour analyses must not accumulate unbounded state)
RESET_VAR_LIMIT = 4_000_000


class _BitsAssignment(dict):
    """Lazy var-term -> value view over a SAT model's bit list.

    The blaster's var tables keep growing after this model is taken; variables
    blasted later (bits beyond the model's length) are treated as absent.
    `keys()` exposes only the *query's own* variables: the pool covers every
    variable ever blasted, and advertising unrelated vars (whose values are
    arbitrary — their root literals were not assumed) would let Model.merge
    clobber sibling models in IndependenceSolver."""

    def __init__(self, bits: List[bool], var_bits: Dict[terms.Term, List[int]],
                 var_lits: Dict[terms.Term, int],
                 query_terms: List[terms.Term]):
        super().__init__()
        self._bits = bits
        self._var_bits = var_bits
        self._var_lits = var_lits
        self._query_terms = query_terms
        self._domain: Optional[set] = None

    def _lit(self, lit: int) -> Optional[bool]:
        index = abs(lit) - 1
        if index >= len(self._bits):
            return None
        value = self._bits[index]
        return value if lit > 0 else not value

    def __missing__(self, key):
        bits = self._var_bits.get(key)
        if bits is not None:
            value = 0
            for position, lit in enumerate(bits):
                bit = self._lit(lit)
                if bit is None:
                    raise KeyError(key)
                if bit:
                    value |= 1 << position
            self[key] = value
            return value
        lit = self._var_lits.get(key)
        if lit is not None:
            bit = self._lit(lit)
            if bit is None:
                raise KeyError(key)
            self[key] = bit
            return bit
        raise KeyError(key)

    def __contains__(self, key):
        if dict.__contains__(self, key):
            return True
        try:
            self[key]
            return True
        except KeyError:
            return False

    def get(self, key, default=None):
        # dict.get bypasses __missing__; route through __getitem__
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        """The query's variable domain (computed on first use; merge in
        IndependenceSolver is the only consumer)."""
        if self._domain is None:
            self._domain = set()
            for root in self._query_terms:
                for node in terms.walk(root):
                    if node.op == "var" and (node in self._var_bits
                                             or node in self._var_lits):
                        self._domain.add(node)
        return list(self._domain | set(dict.keys(self)))


class IncrementalPipeline:
    """One per process (solver.py holds the instance); single-threaded like
    the engine itself."""

    def __init__(self):
        self.blaster = Blaster()
        self.session = sat.Session()
        self.info = LoweringInfo()
        self.lower_cache: Dict[terms.Term, terms.Term] = {}
        #: fresh read/UF var -> its registry record
        self.fresh_read: Dict[terms.Term, Tuple[terms.Term, terms.Term]] = {}
        self.fresh_uf: Dict[terms.Term, Tuple[str, Tuple[terms.Term, ...]]] = {}
        #: memo: lowered term -> frozenset of fresh read/UF vars inside it
        self._fresh_sets: Dict[terms.Term, FrozenSet[terms.Term]] = {}
        self._ack_emitted: set = set()
        self._shipped = 0  # clause-pool cursor already sent to the session
        #: (fresh-var pair, root lit) of every asserted Ackermann fact — the
        #: device cone extractor re-asserts the facts relevant to a query
        self._fact_lits: List[Tuple[Tuple[terms.Term, terms.Term], int]] = []

    # -- fresh-var bookkeeping -------------------------------------------------------

    def _sync_registries(self, reads_before: int, ufs_before: int) -> None:
        for base, index, fresh in self.info.array_reads[reads_before:]:
            self.fresh_read[fresh] = (base, index)
        for name, uf_args, fresh in self.info.uf_applications[ufs_before:]:
            self.fresh_uf[fresh] = (name, uf_args)

    def _fresh_set(self, node: terms.Term) -> FrozenSet[terms.Term]:
        hit = self._fresh_sets.get(node)
        if hit is not None:
            return hit
        stack = [node]
        while stack:
            current = stack[-1]
            if current in self._fresh_sets:
                stack.pop()
                continue
            pending = [a for a in current.args if a not in self._fresh_sets]
            if pending:
                stack.extend(pending)
                continue
            stack.pop()
            collected = frozenset().union(
                *(self._fresh_sets[a] for a in current.args)) \
                if current.args else frozenset()
            if current in self.fresh_read or current in self.fresh_uf:
                collected = collected | {current}
            self._fresh_sets[current] = collected
        return self._fresh_sets[node]

    def _query_fresh_closure(self, lowered: List[terms.Term]
                             ) -> FrozenSet[terms.Term]:
        """Fresh read/UF vars reachable from the query, closed over index/arg
        terms (a nested select's inner read only appears via the outer read's
        index term)."""
        seen = set()
        frontier = set()
        for node in lowered:
            frontier |= self._fresh_set(node)
        while frontier:
            fresh = frontier.pop()
            if fresh in seen:
                continue
            seen.add(fresh)
            record = self.fresh_read.get(fresh)
            if record is not None:
                frontier |= self._fresh_set(record[1])
            else:
                name, uf_args = self.fresh_uf[fresh]
                for arg in uf_args:
                    frontier |= self._fresh_set(arg)
        return frozenset(seen)

    def _emit_ackermann(self, fresh_vars: FrozenSet[terms.Term]
                        ) -> List[Tuple[Tuple[terms.Term, terms.Term],
                                        terms.Term]]:
        """Assert (once, unconditionally — they are valid facts) the pairwise
        consistency implications among the query's reads/UF applications.
        Returns (fresh-var pair, fact) so the caller can register the fact's
        root literal for device cone extraction."""
        facts: List[Tuple[Tuple[terms.Term, terms.Term], terms.Term]] = []
        by_base: Dict[int, List[terms.Term]] = {}
        by_name: Dict[str, List[terms.Term]] = {}
        for fresh in sorted(fresh_vars, key=lambda t: t.params[0]):
            record = self.fresh_read.get(fresh)
            if record is not None:
                by_base.setdefault(id(record[0]), []).append(fresh)
            else:
                by_name.setdefault(self.fresh_uf[fresh][0], []).append(fresh)
        for group in by_base.values():
            for fresh_a, fresh_b in itertools.combinations(group, 2):
                key = (fresh_a, fresh_b)
                if key in self._ack_emitted:
                    continue
                self._ack_emitted.add(key)
                fact = read_pair_fact(self.fresh_read[fresh_a][1], fresh_a,
                                      self.fresh_read[fresh_b][1], fresh_b)
                if fact is not None:
                    facts.append(((fresh_a, fresh_b), fact))
        for group in by_name.values():
            for fresh_a, fresh_b in itertools.combinations(group, 2):
                key = (fresh_a, fresh_b)
                if key in self._ack_emitted:
                    continue
                self._ack_emitted.add(key)
                fact = uf_pair_fact(self.fresh_uf[fresh_a][1], fresh_a,
                                    self.fresh_uf[fresh_b][1], fresh_b)
                if fact is not None:
                    facts.append(((fresh_a, fresh_b), fact))
        return facts

    # -- the decision procedure ------------------------------------------------------

    def _prepare(self, raw_constraints: List[terms.Term]):
        """Lower the constraints against the global registries and blast
        them into the monotone pool (all idempotent on repeat: the lower
        cache, structural hashing and the Ackermann emitted-set make a
        second pass over the same set free). Returns
        (lowered, fresh_vars, assumptions). Does NOT ship clauses to the
        native session — the cursor advances only in check(), so a
        speculative prepare leaves session state untouched."""
        reads_before = len(self.info.array_reads)
        ufs_before = len(self.info.uf_applications)
        lowered = [_lower(c, self.lower_cache, self.info)
                   for c in raw_constraints]
        self._sync_registries(reads_before, ufs_before)

        fresh_vars = self._query_fresh_closure(lowered)
        for pair, fact in self._emit_ackermann(fresh_vars):
            # unconditional unit in the pool; the root lit is registered so
            # the device cone extractor can re-assert the relevant facts
            self._fact_lits.append((pair, self.blaster.assert_true(fact)))

        assumptions = [self.blaster.blast_bool(node) for node in lowered]
        return lowered, fresh_vars, assumptions

    def prepare_device_query(self, raw_constraints: List[terms.Term]
                             ) -> Optional[Tuple[List[List[int]], int]]:
        """Build the device cone for a query WITHOUT solving it — the
        prefetch half of the batch dispatch layer (solver.prefetch_formulas).

        Cone extraction is a deterministic traversal and the sub-CNF is
        deterministically renumbered, so a later real check() over the same
        set produces the identical CNF — its dispatch submission dedups
        onto the prefetched entry (or hits the verdict cache). The pool
        mutations here are exactly the monotone ones check() would make;
        session clause shipping stays with check(). Returns
        (clauses, n_vars) or None when the cone exceeds the device cap."""
        _, fresh_vars, assumptions = self._prepare(raw_constraints)
        sub = self._device_subproblem(assumptions, fresh_vars)
        if sub is None:
            return None
        sub_clauses, n_sub_vars, _renumber = sub
        return sub_clauses, n_sub_vars

    def check(self, raw_constraints: List[terms.Term], max_conflicts: int,
              device_solve=None, timeout_ms: int = 0
              ) -> Tuple[str, Optional[Model]]:
        """Same contract as solver.check_formulas. `device_solve` is an
        optional callable(clauses, n_vars, max_conflicts) -> (status, bits)
        used as a pre-pass (the --solver jax lane). timeout_ms > 0 is a hard
        wall-clock deadline enforced inside the native solve loop."""
        lowered, fresh_vars, assumptions = self._prepare(raw_constraints)

        new_clauses = self.blaster.clauses[self._shipped:]
        self._shipped = len(self.blaster.clauses)
        # newly blasted CNF for THIS query (0 for a fully warm repeat) — the
        # observable the simplifier's clause-count regression tests pin
        SolverStatistics().last_query_clauses = len(new_clauses)
        if not self.session.add_clauses(new_clauses, self.blaster.n_vars):
            # the pool itself can only break if a valid fact chain conflicts —
            # which would be a blaster bug; fail closed as unknown
            return "unknown", None

        status, bits = sat.UNKNOWN, None
        if device_solve is not None:
            # the monotone pool outgrows any device cap within a few queries;
            # ship only the query's cone of influence — definitions reachable
            # from the assumption roots plus the Ackermann facts over the
            # query's own reads/UFs (SURVEY §2.3: keep device problems small
            # instead of sharding an almost-entirely-irrelevant matrix)
            sub = self._device_subproblem(assumptions, fresh_vars)
            if sub is not None:
                sub_clauses, n_sub_vars, renumber = sub
                status, sub_bits = device_solve(sub_clauses, n_sub_vars,
                                                max_conflicts)
                if status == sat.SAT and sub_bits is not None:
                    bits = [False] * self.blaster.n_vars
                    for global_var, sub_var in renumber.items():
                        if sub_var - 1 < len(sub_bits):
                            bits[global_var - 1] = sub_bits[sub_var - 1]
        if status == sat.UNKNOWN:
            status, bits = self._session_solve(assumptions, max_conflicts,
                                               timeout_ms)

        if status == sat.UNSAT:
            return "unsat", None
        if status == sat.UNKNOWN:
            return "unknown", None
        return "sat", self._build_model(bits, fresh_vars, lowered)

    def _session_solve(self, assumptions: List[int], max_conflicts: int,
                       timeout_ms: int) -> Tuple[int, Optional[List[bool]]]:
        """Native session solve behind its circuit breaker
        (support/resilience.py), degrading to the pure-Python DPLL over the
        full pool + one unit per assumption — the ladder floor decides the
        same question, just much slower."""
        from ...support import resilience

        health = resilience.registry.backend(resilience.NATIVE)
        if health.allow():
            try:
                resilience.fire(resilience.NATIVE)
                status, bits = self.session.solve(
                    assumptions, self.blaster.n_vars, max_conflicts,
                    timeout_ms)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as error:
                failure_class = (error.failure_class
                                 if isinstance(error,
                                               resilience.BackendFailure)
                                 else resilience.NATIVE_CRASH)
                log.warning(
                    "native CDCL session failed [%s] (%r) under %d "
                    "assumptions — degrading to the pure-Python DPLL",
                    failure_class, error, len(assumptions))
                health.record_failure(failure_class, repr(error))
            else:
                health.record_success()
                return status, bits
        return sat.solve_cnf_python(
            self.blaster.clauses + [[lit] for lit in assumptions],
            self.blaster.n_vars, max_conflicts)

    def _device_subproblem(self, assumptions: List[int],
                           fresh_vars: FrozenSet[terms.Term]):
        """Extract the query's cone of influence from the monotone pool as a
        self-contained renumbered CNF for the device DPLL.

        Included: the pinned-TRUE unit, every gate definition reachable
        downward from the assumption roots and from the relevant Ackermann
        fact roots (facts whose fresh-var pair lies inside the query's
        closure), the fact units themselves, and one unit per assumption.
        Soundness: definitions are full biconditionals, so a model of the
        cone extends to the excluded gates functionally, and excluded fact
        units only constrain reads outside the query's closure (the same
        per-query pairing the one-shot pipeline uses). Returns
        (clauses, n_vars, {global_var: sub_var}) or None when the cone
        exceeds the device cap."""
        from ...parallel.device_solver import DEFAULT_CLAUSE_CAP

        blaster = self.blaster
        fact_lits = [lit for pair, lit in self._fact_lits
                     if pair[0] in fresh_vars and pair[1] in fresh_vars]
        clause_indices: List[int] = [0]  # pinned TRUE
        stack = [abs(lit) for lit in assumptions] \
            + [abs(lit) for lit in fact_lits]
        visited = set()
        budget = DEFAULT_CLAUSE_CAP - len(fact_lits) - len(assumptions) - 1
        while stack:
            var = stack.pop()
            if var in visited or var == 1:
                continue
            visited.add(var)
            definition = blaster.gate_clauses.get(var)
            if definition is None:
                continue  # input bit: leaf
            start, count = definition
            clause_indices.extend(range(start, start + count))
            if len(clause_indices) > budget:
                return None
            stack.extend(blaster.gate_children[var])

        renumber: Dict[int, int] = {1: 1}

        def sub_lit(lit: int) -> int:
            var = abs(lit)
            sub_var = renumber.get(var)
            if sub_var is None:
                sub_var = len(renumber) + 1
                renumber[var] = sub_var
            return sub_var if lit > 0 else -sub_var

        sub_clauses = [[sub_lit(lit) for lit in blaster.clauses[index]]
                       for index in clause_indices]
        sub_clauses += [[sub_lit(lit)] for lit in fact_lits]
        sub_clauses += [[sub_lit(lit)] for lit in assumptions]
        return sub_clauses, len(renumber), renumber

    def _build_model(self, bits: List[bool], fresh_vars: FrozenSet[terms.Term],
                     lowered: List[terms.Term]) -> Model:
        model = Model()
        model.assignment = _BitsAssignment(
            bits, self.blaster.var_bits, self.blaster.var_lits,
            lowered + sorted(fresh_vars, key=lambda t: t.params[0]))
        # rebuild array/UF tables from the query's own reads only: reads from
        # other queries have unconstrained values here and must not collide
        for fresh in sorted(fresh_vars, key=lambda t: t.params[0]):
            record = self.fresh_read.get(fresh)
            if record is not None:
                base, index = record
                index_value = model.eval(index)
                model.arrays.setdefault(base, {})[index_value] = \
                    model.assignment.get(fresh, 0)
            else:
                name, uf_args = self.fresh_uf[fresh]
                arg_values = tuple(model.eval(a) for a in uf_args)
                model.ufs[(name, arg_values)] = model.assignment.get(fresh, 0)
        return model

    @property
    def needs_reset(self) -> bool:
        return self.blaster.n_vars > RESET_VAR_LIMIT

    def close(self) -> None:
        self.session.close()
