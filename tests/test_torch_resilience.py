"""The port's failure taxonomy, circuit breaker, fault plan and host
degradation ladder (mythril_tpu_torch/support/resilience.py,
smt/solver/sat.py) against the JAX package's, on the host cases of
tests/test_resilience.py; and the port's own build of the native CDCL
(mythril_tpu_torch/native).

Each resilience case runs on both packages from a fresh registry and plan
and returns what it observed; the two must be equal. The device,
checkpoint and analysis cases of tests/test_resilience.py wait for the
port's batch dispatch (ROADMAP A 10; the analysis case runs under
`--solver jax`) and its frontier driver with checkpoints (A 7)."""

import os
import shutil
from types import SimpleNamespace

import pytest

from mythril_tpu.smt.solver import dispatch as jdispatch
from mythril_tpu.smt.solver import sat as jsat
from mythril_tpu.smt.solver import solver as jsolver
from mythril_tpu.smt.solver import solver_statistics as jstatistics
from mythril_tpu.support import resilience as jresilience
from mythril_tpu.support import support_args as jsupport_args
from mythril_tpu_torch import native
from mythril_tpu_torch.smt.solver import sat as psat
from mythril_tpu_torch.smt.solver import solver as psolver
from mythril_tpu_torch.smt.solver import solver_statistics as pstatistics
from mythril_tpu_torch.support import resilience as presilience
from mythril_tpu_torch.support import support_args as psupport_args

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

JAX = SimpleNamespace(name="jax", resilience=jresilience, sat=jsat,
                      solver=jsolver, stats=jstatistics.SolverStatistics,
                      args=jsupport_args.args)
PORT = SimpleNamespace(name="port", resilience=presilience, sat=psat,
                       solver=psolver, stats=pstatistics.SolverStatistics,
                       args=psupport_args.args)

SAT_CNF = ([[1, 2], [-1], [2]], 2, 1)
UNSAT_CNF = ([[1], [-1]], 1, 0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for side in (JAX, PORT):
        side.resilience.reset()
        side.stats().reset()
        monkeypatch.setattr(side.args, "device_crosscheck", 0)
    jdispatch.reset()
    yield
    for side in (JAX, PORT):
        side.resilience.reset()
        side.stats().reset()
    jdispatch.reset()


def observe(case):
    """(port, jax) observations of one case."""
    out = {}
    for side in (JAX, PORT):
        side.resilience.reset()
        side.stats().reset()
        out[side.name] = case(side)
    return out["port"], out["jax"]


# ---- the cases of tests/test_resilience.py -------------------------------------------

def res_classify_failure_taxonomy(s):
    r = s.resilience

    class UnexpectedTracerError(Exception):
        pass

    errors = [r.DeviceOOM("x"), MemoryError(),
              RuntimeError("RESOURCE_EXHAUSTED: hbm allocator"), TimeoutError(),
              UnexpectedTracerError("leak"),
              RuntimeError("INVALID_ARGUMENT: bad shape"), RuntimeError("boom"),
              r.NativeCrash("x"), r.WorkerHang("x")]
    classes = [r.classify_failure(error) for error in errors]
    assert classes[:7] == [r.DEVICE_OOM, r.DEVICE_OOM, r.DEVICE_OOM,
                           r.WALL_OVERRUN, r.COMPILE_ERROR, r.COMPILE_ERROR,
                           r.WORKER_CRASH]
    return classes + [r.classify_failure(MemoryError(), "worker"),
                      [r.classify_exit_status(code)
                       for code in (None, 0, -11, -9, -15, 3)]]


def res_fault_plan_nth_semantics(s):
    r = s.resilience
    runs = []
    for spec, site in (("device_oom:3", "device"), ("native_crash:2+", "native"),
                       ("divergence:*", "divergence"), ("device_oom", "native"),
                       ("device_oom", "device")):
        plan = r.FaultPlan(spec)
        runs.append([plan.visit(site) for _ in range(4)])
    assert runs[0] == [None, None, r.DEVICE_OOM, None]
    assert runs[1] == [None] + [r.NATIVE_CRASH] * 3
    with pytest.raises(ValueError):
        r.FaultPlan("segfault:1")
    return runs


def res_fire_raises_typed_exception(s):
    r = s.resilience
    r.configure("compile_error:1,native_crash:2")
    raised = []
    for site in ("device", "device", "native", "native"):
        try:
            r.fire(site)
            raised.append(None)
        except r.BackendFailure as error:
            raised.append((type(error).__name__, error.failure_class))
    assert raised[0] == ("DeviceCompileError", r.COMPILE_ERROR)
    assert r.take("divergence") is False
    return raised + [r.plan().fired]


def res_breaker_trips_recovers_and_counts(s):
    r = s.resilience
    health = r.BackendHealth("device", trip_after=3, recovery_after=4)
    stats = s.stats()
    states = []
    for _ in range(3):
        health.record_failure(r.DEVICE_OOM, "e")
        states.append(health.state)
    allowed = [health.allow() for _ in range(4)]
    health.record_success()
    states.append(health.state)
    health.record_failure(r.DEVICE_OOM, "e")
    health.record_success()
    for _ in range(2):
        health.record_failure(r.DEVICE_OOM, "e")
    states.append(health.state)
    assert states == [r.CLOSED, r.CLOSED, r.OPEN, r.CLOSED, r.CLOSED]
    assert allowed == [False, False, False, True]
    return [states, allowed, stats.breaker_trips, stats.breaker_recoveries,
            dict(stats.failure_counts), health.trips, health.recoveries]


def res_failed_recovery_probe_rearms_skip_window(s):
    r = s.resilience
    health = r.BackendHealth("device", trip_after=1, recovery_after=3)
    health.record_failure(r.WORKER_CRASH, "e")
    first = [health.allow() for _ in range(3)]
    health.record_failure(r.WORKER_CRASH, "probe failed")
    second = [health.allow() for _ in range(3)]
    assert first == second == [False, False, True]
    return [health.state, first, second, health.last_failure]


def res_divergence_quarantines_permanently(s):
    r = s.resilience
    health = r.BackendHealth("device", trip_after=3)
    health.record_failure(r.DIVERGENCE, "wrong verdict")
    health.record_success()
    assert health.state == r.QUARANTINED and not health.allow()
    return [health.state, list(s.stats().backends_quarantined)]


def res_registry_states(s):
    r = s.resilience
    r.registry.backend(r.NATIVE).record_failure(r.NATIVE_CRASH, "e")
    r.registry.backend(r.DEVICE)
    health = r.registry.backend(r.NATIVE)
    return [r.registry.states(), health.trip_after, health.recovery_after,
            r.device_wall_budget_ms(), r.crosscheck_every()]


def res_python_floor_verdicts(s):
    verdicts = []
    for clauses, n_vars, expected in (SAT_CNF, UNSAT_CNF):
        status, model = s.sat.solve_cnf_python(clauses, n_vars)
        assert status == expected
        if status == 1:
            assert all(any((lit > 0) == model[abs(lit) - 1] for lit in clause)
                       for clause in clauses)
        verdicts.append((status, model))
    return verdicts


def res_native_rung_matches_python_floor(s):
    return [s.sat.solve_cnf_native(clauses, n_vars)
            for clauses, n_vars, _ in (SAT_CNF, UNSAT_CNF)]


def res_native_failure_degrades_to_python_same_verdict(s):
    """native_crash at every visit of the native boundary: the verdicts
    come from the Python floor, the failures are classified, the breaker
    trips after three and then skips the boundary."""
    r = s.resilience
    r.configure("native_crash:*")
    verdicts = [s.sat.solve_cnf(clauses, n_vars)[0]
                for clauses, n_vars, _ in (SAT_CNF, UNSAT_CNF, SAT_CNF)]
    state = r.registry.backend(r.NATIVE).state
    visits = r.plan().site_counts.get("native")
    verdicts.append(s.sat.solve_cnf(*SAT_CNF[:2])[0])
    assert verdicts == [1, 0, 1, 1] and state == r.OPEN
    assert r.plan().site_counts.get("native") == visits == 3
    return [verdicts, state, visits, dict(s.stats().failure_counts)]


def res_crosscheck_device_verdict(s):
    """The divergence cross-check (`--device-crosscheck`): a sampled device
    verdict the host CDCL disproves quarantines the device backend and the
    host's answer is returned; a verdict it confirms stands."""
    r = s.resilience
    solver = s.solver
    s.args.device_crosscheck = 1
    confirmed = solver._crosscheck_device_verdict(
        SAT_CNF[0], SAT_CNF[1], 1000, 1, [False, True])
    r.configure("divergence:1")
    flipped = solver._crosscheck_device_verdict(
        SAT_CNF[0], SAT_CNF[1], 1000, 1, [False, True])
    stats = s.stats()
    assert confirmed == (1, [False, True]) and flipped[0] == 1
    assert r.registry.backend(r.DEVICE).state == r.QUARANTINED
    return [confirmed, flipped, stats.crosschecks, stats.divergences,
            solver._model_satisfies(SAT_CNF[0], [True, True]),
            solver._model_satisfies(SAT_CNF[0], [False, True])]


RESILIENCE_CASES = [res_classify_failure_taxonomy, res_fault_plan_nth_semantics,
                    res_fire_raises_typed_exception,
                    res_breaker_trips_recovers_and_counts,
                    res_failed_recovery_probe_rearms_skip_window,
                    res_divergence_quarantines_permanently, res_registry_states,
                    res_python_floor_verdicts,
                    res_native_rung_matches_python_floor,
                    res_native_failure_degrades_to_python_same_verdict,
                    res_crosscheck_device_verdict]


@pytest.mark.parametrize("case", RESILIENCE_CASES, ids=lambda c: c.__name__[4:])
def test_resilience_case(case):
    """A host case of tests/test_resilience.py on both packages."""
    got, want = observe(case)
    assert got == want


def test_session_failure_degrades_to_python_same_verdict():
    """A native failure inside the incremental pipeline's session solve is
    answered by the Python floor over the pool, with the CDCL's verdict."""
    from mythril_tpu_torch.smt import symbol_factory, UGT, ULT

    psolver.reset_solver_backend()
    x = symbol_factory.BitVecSym("res_x", 8)
    healthy = psolver.check_formulas([UGT(x, 200).raw, ULT(x, 202).raw])
    presilience.configure("native_crash:*")
    degraded = psolver.check_formulas([UGT(x, 200).raw, ULT(x, 202).raw])
    unsat = psolver.check_formulas([UGT(x, 201).raw, ULT(x, 202).raw])
    assert healthy[0] == degraded[0] == "sat" and unsat[0] == "unsat"
    assert healthy[1].eval(x) == degraded[1].eval(x) == 201
    assert pstatistics.SolverStatistics().failure_counts == \
        {"native:native_crash": 2}
    psolver.reset_solver_backend()


def test_configure_sets_the_knobs_reset_restores_them():
    """The JAX package's MYTHRIL_TPU_BREAKER_* / _DEVICE_WALL_MS /
    _CROSSCHECK environment knobs are configure() arguments in the port,
    with the same defaults."""
    r = presilience
    assert (r.DEFAULT_TRIP_AFTER, r.DEFAULT_RECOVERY_AFTER,
            r.DEFAULT_DEVICE_WALL_MS, r.DEFAULT_CROSSCHECK) == (3, 32, 120_000, 0)
    r.configure(None, trip_after=1, recovery_after=2, device_wall_ms=5,
                crosscheck=7)
    health = r.registry.backend(r.NATIVE)
    assert (health.trip_after, health.recovery_after) == (1, 2)
    assert (r.device_wall_budget_ms(), r.crosscheck_every()) == (5, 7)
    health.record_failure(r.NATIVE_CRASH, "e")
    assert health.state == r.OPEN
    r.reset()
    health = r.registry.backend(r.NATIVE)
    assert (health.trip_after, health.recovery_after, health.state) == \
        (3, 32, r.CLOSED)
    assert (r.device_wall_budget_ms(), r.crosscheck_every()) == (120_000, 0)


# ---- the port's CDCL build ---------------------------------------------------------------

def test_cdcl_library_is_the_ports_own():
    """The port builds native/cdcl.cpp's copy into its own build directory,
    under a name that carries the source's hash, and loads it beside the JAX
    package's library: one process, two libraries, the same answers."""
    path = psat._load_lib()._name
    assert path == native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "mythril_tpu_torch",
                                                 "native", "build")
    assert not path.startswith(os.path.join(REPO, "native") + os.sep)
    assert os.path.basename(path).startswith("libmythril_cdcl-")
    reference = jsat._load_lib()
    assert reference is not None and reference._name != path
    assert os.path.realpath(reference._name) != os.path.realpath(path)
    for clauses, n_vars, expected in (SAT_CNF, UNSAT_CNF):
        got = psat.solve_cnf_native(clauses, n_vars)
        assert got == jsat.solve_cnf_native(clauses, n_vars)
        assert got[0] == expected


def test_cdcl_library_name_follows_the_source(tmp_path):
    source = tmp_path / "cdcl.cpp"
    shutil.copy(native.SOURCE, source)
    same = native.library_path(str(source), str(tmp_path))
    assert os.path.basename(same) == os.path.basename(native.library_path())
    with open(source, "a") as handle:
        handle.write("// edited\n")
    assert native.library_path(str(source), str(tmp_path)) != same


def test_failed_cdcl_build_raises_with_the_compiler_output(tmp_path,
                                                           monkeypatch):
    """A source that does not compile raises NativeBuildError with g++'s
    message, leaves no library behind, and a solve behind it raises rather
    than answer on the Python DPLL."""
    broken = tmp_path / "cdcl.cpp"
    shutil.copy(native.SOURCE, broken)
    with open(broken, "a") as handle:
        handle.write("\nthis is not C++;\n")
    build_dir = tmp_path / "build"
    with pytest.raises(native.NativeBuildError, match="error") as raised:
        native.build(str(broken), str(build_dir))
    assert "this is not C++" in str(raised.value)
    assert not any(name.endswith(".so") for name in os.listdir(build_dir))

    build = native.build
    monkeypatch.setattr(psat, "_lib", None)
    monkeypatch.setattr(native, "build",
                        lambda: build(str(broken), str(build_dir)))
    with pytest.raises(native.NativeBuildError):
        psat.solve_cnf(*SAT_CNF[:2])
    with pytest.raises(native.NativeBuildError):
        psat.Session()
    assert pstatistics.SolverStatistics().failure_counts == {}
    assert presilience.plan().site_counts == {}
    assert psat._lib is None
