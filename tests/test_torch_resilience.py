"""The port's failure taxonomy, circuit breaker, fault plan and host
degradation ladder (mythril_tpu_torch/support/resilience.py,
smt/solver/sat.py) against the JAX package's, on the host cases of
tests/test_resilience.py; and the port's own build of the native CDCL
(mythril_tpu_torch/native).

Each resilience case runs on both packages from a fresh registry and plan
and returns what it observed; the two must be equal. The device cases
stub the device entry point with the Python DPLL, as the reference test
does, at the lane module the dispatch resolves it on (the JAX package's
`parallel/jax_solver`, the port's `parallel/device_solver`) and reach it
through `solver._device_solve` (the batch dispatch). The checkpoint cases
and the analysis under `--solver jax` are in tests/test_torch_checkpoint.py
and tests/test_torch_device_lane.py."""

import os
import shutil
from types import SimpleNamespace

import pytest

from mythril_tpu.parallel import jax_solver
from mythril_tpu.smt.solver import dispatch as jdispatch
from mythril_tpu.smt.solver import sat as jsat
from mythril_tpu.smt.solver import solver as jsolver
from mythril_tpu.smt.solver import solver_statistics as jstatistics
from mythril_tpu.support import resilience as jresilience
from mythril_tpu.support import support_args as jsupport_args
from mythril_tpu_torch import native
from mythril_tpu_torch.parallel import device_solver
from mythril_tpu_torch.smt.solver import dispatch as pdispatch
from mythril_tpu_torch.smt.solver import sat as psat
from mythril_tpu_torch.smt.solver import solver as psolver
from mythril_tpu_torch.smt.solver import solver_statistics as pstatistics
from mythril_tpu_torch.support import resilience as presilience
from mythril_tpu_torch.support import support_args as psupport_args

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

JAX = SimpleNamespace(name="jax", resilience=jresilience, sat=jsat,
                      solver=jsolver, stats=jstatistics.SolverStatistics,
                      args=jsupport_args.args, lane=jax_solver,
                      dispatch=jdispatch)
PORT = SimpleNamespace(name="port", resilience=presilience, sat=psat,
                       solver=psolver, stats=pstatistics.SolverStatistics,
                       args=psupport_args.args, lane=device_solver,
                       dispatch=pdispatch)

SAT_CNF = ([[1, 2], [-1], [2]], 2, 1)
UNSAT_CNF = ([[1], [-1]], 1, 0)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for side in (JAX, PORT):
        side.resilience.reset()
        side.stats().reset()
        monkeypatch.setattr(side.args, "device_crosscheck", 0)
        side.dispatch.reset()
    # the port's lane on the CPU (its stubbed twin), where a host
    # MemoryError is classified as the reference classifies its stub's
    pdispatch.configure(device="cpu")
    yield
    for side in (JAX, PORT):
        side.resilience.reset()
        side.stats().reset()
        side.dispatch.reset()
    pdispatch.reset_settings()


def observe(case):
    """(port, jax) observations of one case."""
    out = {}
    for side in (JAX, PORT):
        side.resilience.reset()
        side.stats().reset()
        side.dispatch.reset()
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


def stub_device(s, patch, device=None):
    """The device entry point stubbed at the lane module: the Python DPLL
    unless `device` is given."""
    patch.setattr(s.lane, "solve_cnf_device", device or (
        lambda clauses, n_vars, **kw: s.sat.solve_cnf_python(clauses,
                                                             n_vars)))


def device_record(s) -> list:
    stats = s.stats()
    return [stats.device_queries, stats.device_solved, stats.device_skipped,
            stats.device_fallbacks, stats.crosschecks, stats.divergences,
            dict(stats.failure_counts), list(stats.backends_quarantined),
            s.resilience.registry.backend(s.resilience.DEVICE).state]


def res_device_rung_matches_host_verdicts(s):
    """A healthy device gives the host rungs' verdicts."""
    with pytest.MonkeyPatch.context() as patch:
        stub_device(s, patch)
        verdicts = [s.solver._device_solve(clauses, n_vars, 10_000)
                    for clauses, n_vars, _ in (SAT_CNF, UNSAT_CNF)]
    assert [status for status, _ in verdicts] == [1, 0]
    assert s.stats().device_solved == 2 and s.stats().failure_counts == {}
    return [verdicts, device_record(s)]


def res_device_failure_classified_then_breaker_skips(s):
    """A device out of memory three times: classified, the breaker OPEN,
    then the device is not called at all."""
    calls = []

    def exploding_device(clauses, n_vars, **kw):
        calls.append(1)
        raise MemoryError("hbm oom")

    with pytest.MonkeyPatch.context() as patch:
        stub_device(s, patch, exploding_device)
        statuses = [s.solver._device_solve(*SAT_CNF[:2], 10_000)[0]
                    for _ in range(s.resilience.DEFAULT_TRIP_AFTER)]
        state = s.resilience.registry.backend(s.resilience.DEVICE).state
        before = len(calls)
        skipped = s.solver._device_solve(*SAT_CNF[:2], 10_000)
    assert statuses == [-1] * 3 and state == s.resilience.OPEN
    assert skipped[0] == -1 and len(calls) == before
    assert s.stats().failure_counts == {"device:device_oom": 3}
    return [statuses, state, skipped, len(calls), device_record(s)]


def res_device_divergence_quarantined_host_verdict_wins(s):
    """An injected divergence flips the device verdict; the cross-check
    disproves it, quarantines the device and answers with the host's."""
    s.resilience.configure("divergence:1")
    clauses, n_vars, _ = SAT_CNF
    with pytest.MonkeyPatch.context() as patch:
        stub_device(s, patch)
        first = s.solver._device_solve(clauses, n_vars, 10_000)
        second = s.solver._device_solve(clauses, n_vars, 10_000)
    assert first[0] == 1 and first[1] is not None and second[0] == -1
    assert s.stats().divergences == 1
    assert s.stats().backends_quarantined == ["device"]
    return [first, second, device_record(s)]


def res_sampled_crosscheck_passes_healthy_device(s):
    s.args.device_crosscheck = 1
    with pytest.MonkeyPatch.context() as patch:
        stub_device(s, patch)
        verdicts = [s.solver._device_solve(clauses, n_vars, 10_000)
                    for clauses, n_vars, _ in (SAT_CNF, UNSAT_CNF)]
    assert [status for status, _ in verdicts] == [1, 0]
    assert (s.stats().crosschecks, s.stats().divergences) == (2, 0)
    assert s.resilience.registry.backend(s.resilience.DEVICE).state == \
        s.resilience.CLOSED
    return [verdicts, device_record(s)]


RESILIENCE_CASES = [res_classify_failure_taxonomy, res_fault_plan_nth_semantics,
                    res_fire_raises_typed_exception,
                    res_breaker_trips_recovers_and_counts,
                    res_failed_recovery_probe_rearms_skip_window,
                    res_divergence_quarantines_permanently, res_registry_states,
                    res_python_floor_verdicts,
                    res_native_rung_matches_python_floor,
                    res_native_failure_degrades_to_python_same_verdict,
                    res_crosscheck_device_verdict,
                    res_device_rung_matches_host_verdicts,
                    res_device_failure_classified_then_breaker_skips,
                    res_device_divergence_quarantined_host_verdict_wins,
                    res_sampled_crosscheck_passes_healthy_device]


@pytest.mark.parametrize("case", RESILIENCE_CASES, ids=lambda c: c.__name__[4:])
def test_resilience_case(case):
    """A case of tests/test_resilience.py on both packages."""
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


#: the smallest input on which both packages' CDCL answers SAT for an
#: unsatisfiable CNF: the units come after the clause they falsify, and
#: `cancel_until(0)` in `add_clause` moves the propagation head past them
#: (ROADMAP C)
LEVEL0_UNITS = [[1, 2], [-1], [-2]]


def test_crosscheck_holds_the_oracle_to_the_clauses():
    """A device UNSAT that the host CDCL "refutes" with an assignment that
    falsifies the clauses stands on the port only when the CDCL, asked
    again with the unit clauses first, proves it UNSAT; it is counted as an
    oracle fault, with the device's breaker CLOSED. The JAX package
    quarantines its device on the same answer. Both CDCLs give that answer
    (the reference's fault, copied with the source). A second answer that
    still fails the clauses is a divergence on the port too."""
    for side in (JAX, PORT):
        status, model = side.sat.solve_cnf(LEVEL0_UNITS, 2)
        assert (status, model) == (1, [False, False])
        assert side.sat.solve_cnf_python(LEVEL0_UNITS, 2)[0] == 0
    assert PORT.solver._units_first(LEVEL0_UNITS) == [[-1], [-2], [1, 2]]
    assert PORT.sat.solve_cnf([[-1], [-2], [1, 2]], 2)[0] == 0

    def crosscheck(side):
        side.resilience.reset()
        side.stats().reset()
        side.args.device_crosscheck = 1
        verdict = side.solver._crosscheck_device_verdict(
            LEVEL0_UNITS, 2, 1000, 0, None)
        states = side.resilience.registry.backend(side.resilience.DEVICE)
        return verdict + (states.state, side.stats().divergences)

    verdicts = {side.name: crosscheck(side) for side in (JAX, PORT)}
    assert verdicts["port"] == (0, None, "closed", 0)
    assert verdicts["jax"] == (1, [False, False], "quarantined", 1)
    assert (PORT.stats().oracle_faults, PORT.stats().oracle_confirmed) == \
        (1, 1)
    # a second witness as faulty as the first confirms nothing
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(PORT.sat, "solve_cnf",
                      lambda clauses, n_vars, *rest: (1, [False, False]))
        assert crosscheck(PORT) == (1, [False, False], "quarantined", 1)
    assert (PORT.stats().oracle_faults, PORT.stats().oracle_confirmed) == \
        (1, 0)
