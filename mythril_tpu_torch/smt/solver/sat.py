"""SAT backend bindings: the port's copy of the native CDCL core
(mythril_tpu_torch/native/cdcl.cpp via ctypes) and the pure-Python DPLL floor
of the degradation ladder.

The port's copy of mythril_tpu/smt/solver/sat.py, but for how the library
is found: the JAX package loads native/build/libmythril_native.so and drops
to the Python DPLL when it is missing or fails to build; the port builds
its own copy at first use (mythril_tpu_torch/native) and a failed build
raises with the compiler's output. A native failure *while solving* is
classified, recorded on the breaker and answered by the Python DPLL, as in
the JAX package (`solve_cnf`, incremental.py `_session_solve`)."""

from __future__ import annotations

import ctypes
import logging
from typing import List, Optional, Tuple

from ... import native

log = logging.getLogger(__name__)

SAT, UNSAT, UNKNOWN = 1, 0, -1

_lib = None


def _load_lib() -> ctypes.CDLL:
    """The CDCL library, built on first use; raises when it cannot be built
    or loaded."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(native.build())
        lib.mtpu_solve.argtypes = [ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
                                   ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p,
                                   ctypes.c_int64]
        lib.mtpu_solve.restype = ctypes.c_int
        lib.mtpu_session_new.argtypes = []
        lib.mtpu_session_new.restype = ctypes.c_void_p
        lib.mtpu_session_free.argtypes = [ctypes.c_void_p]
        lib.mtpu_session_free.restype = None
        lib.mtpu_session_add.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_size_t, ctypes.c_int32]
        lib.mtpu_session_add.restype = ctypes.c_int
        lib.mtpu_session_solve.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int32),
                                           ctypes.c_size_t, ctypes.c_int64,
                                           ctypes.c_char_p, ctypes.c_int32,
                                           ctypes.c_int64]
        lib.mtpu_session_solve.restype = ctypes.c_int
        _lib = lib
    return _lib


def _flatten(clauses: List[List[int]]):
    total = sum(len(c) + 1 for c in clauses)
    flat = (ctypes.c_int32 * max(1, total))()
    pos = 0
    for clause in clauses:
        for lit in clause:
            flat[pos] = lit
            pos += 1
        flat[pos] = 0
        pos += 1
    return flat, total


class Session:
    """Long-lived native CDCL fed a monotone clause pool and queried under
    assumption literals; learned clauses / activities / phases persist across
    queries (the z3-incrementality equivalent, reference support/model.py:69)."""

    def __init__(self):
        self._lib = _load_lib()
        self._handle = self._lib.mtpu_session_new()
        self.broken = False

    def add_clauses(self, clauses: List[List[int]], max_var: int) -> bool:
        if self.broken or not clauses:
            return not self.broken
        flat, total = _flatten(clauses)
        ok = self._lib.mtpu_session_add(self._handle, flat, total, max_var)
        if not ok:
            self.broken = True
        return not self.broken

    def solve(self, assumptions: List[int], n_vars: int,
              max_conflicts: int = 2_000_000, timeout_ms: int = 0
              ) -> Tuple[int, Optional[List[bool]]]:
        """timeout_ms > 0 enforces a wall-clock deadline inside the native
        solve loop (the conflict budget is only a throughput proxy)."""
        if self.broken:
            return UNSAT, None
        assume = (ctypes.c_int32 * max(1, len(assumptions)))(*assumptions)
        model_buf = ctypes.create_string_buffer(max(1, n_vars))
        status = self._lib.mtpu_session_solve(
            self._handle, assume, len(assumptions), max_conflicts,
            model_buf, n_vars, timeout_ms)
        if status == SAT:
            return SAT, [model_buf.raw[v] == 1 for v in range(n_vars)]
        return status, None

    def close(self) -> None:
        if self._handle:
            self._lib.mtpu_session_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def solve_cnf_native(clauses: List[List[int]], n_vars: int,
                     max_conflicts: int = 2_000_000, timeout_ms: int = 0
                     ) -> Tuple[int, Optional[List[bool]]]:
    """One-shot native CDCL solve (no breaker, no fallback: callers wanting
    graceful degradation go through solve_cnf)."""
    lib = _load_lib()
    flat, total = _flatten(clauses)
    model_buf = ctypes.create_string_buffer(max(1, n_vars))
    status = lib.mtpu_solve(flat, total, n_vars, max_conflicts, model_buf,
                            timeout_ms)
    if status == SAT:
        return SAT, [model_buf.raw[v] == 1 for v in range(n_vars)]
    return status, None


def solve_cnf_python(clauses: List[List[int]], n_vars: int,
                     max_conflicts: int = 2_000_000
                     ) -> Tuple[int, Optional[List[bool]]]:
    """The unconditional ladder floor: pure-Python DPLL. Orders of magnitude
    slower than the native core, but it cannot crash a worker and needs no
    artifacts — it is never breaker-gated."""
    return _python_dpll(clauses, n_vars, max_conflicts)


def solve_cnf(clauses: List[List[int]], n_vars: int,
              max_conflicts: int = 2_000_000, timeout_ms: int = 0
              ) -> Tuple[int, Optional[List[bool]]]:
    """Returns (status, model). model[v-1] is the boolean for DIMACS var v on SAT.

    Degradation ladder (support/resilience.py): native CDCL when its circuit
    breaker allows, pure-Python DPLL otherwise. A native failure is classified
    and counted; `trip_after` consecutive failures trip the breaker and all
    queries run on the Python floor until a recovery probe succeeds. The
    library is built before the ladder is entered: a failed build raises."""
    from ...support import resilience

    _load_lib()
    health = resilience.registry.backend(resilience.NATIVE)
    if health.allow():
        try:
            resilience.fire(resilience.NATIVE)
            status, model = solve_cnf_native(clauses, n_vars, max_conflicts,
                                             timeout_ms)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as error:
            failure_class = (error.failure_class
                             if isinstance(error, resilience.BackendFailure)
                             else resilience.NATIVE_CRASH)
            log.warning(
                "native CDCL failed [%s] (%r) on %d clauses / %d vars — "
                "degrading to the pure-Python DPLL", failure_class, error,
                len(clauses), n_vars)
            health.record_failure(failure_class, repr(error))
        else:
            health.record_success()
            return status, model
    return _python_dpll(clauses, n_vars, max_conflicts)


def _python_dpll(clauses: List[List[int]], n_vars: int,
                 budget: int) -> Tuple[int, Optional[List[bool]]]:
    """Minimal iterative DPLL with unit propagation (fallback only)."""
    assign: dict = {}
    trail: List[List[int]] = []

    def value(lit: int):
        v = assign.get(abs(lit))
        if v is None:
            return None
        return v if lit > 0 else not v

    def propagate() -> bool:
        changed = True
        while changed:
            changed = False
            for clause in clauses:
                unassigned = None
                satisfied = False
                count = 0
                for lit in clause:
                    val = value(lit)
                    if val is True:
                        satisfied = True
                        break
                    if val is None:
                        unassigned = lit
                        count += 1
                if satisfied:
                    continue
                if count == 0:
                    return False
                if count == 1:
                    assign[abs(unassigned)] = unassigned > 0
                    trail[-1].append(abs(unassigned))
                    changed = True
        return True

    trail.append([])
    decisions: List[Tuple[int, bool]] = []
    steps = 0
    while True:
        steps += 1
        if steps > budget:
            return UNKNOWN, None
        if propagate():
            free = next((v for v in range(1, n_vars + 1) if v not in assign), None)
            if free is None:
                return SAT, [assign.get(v, False) for v in range(1, n_vars + 1)]
            decisions.append((free, False))
            trail.append([])
            assign[free] = True
            trail[-1].append(free)
        else:
            while decisions:
                var, tried_both = decisions.pop()
                for v in trail.pop():
                    assign.pop(v, None)
                if not tried_both:
                    decisions.append((var, True))
                    trail.append([])
                    assign[var] = False
                    trail[-1].append(var)
                    break
            else:
                return UNSAT, None
