"""The port's batched device SAT dispatch (mythril_tpu_torch/smt/solver/
dispatch.py) against the JAX package's (mythril_tpu/smt/solver/
dispatch.py), on the 22 cases of tests/test_batch_dispatch.py.

Each case is written once over a `Side` and runs on both packages from a
fresh queue, verdict cache, breaker registry and statistics; it returns
what it observed — verdicts and models, the device calls each batch made,
the statistics' batch, cache, dedup, fallback and skip counts, the
breaker's state and failures and the fault plan's visits — and the two
must be equal. As in the reference test the device entry points are
stubbed with the Python DPLL (`sat.solve_cnf_python`) at the lane module's
attributes, where `_execute_batch` resolves them: the JAX package's
`parallel/jax_solver`, the port's `parallel/device_solver`. The JAX
package's knobs (MYTHRIL_TPU_BATCH_FLUSH, _BATCH_AGE_MS, _VERDICT_CACHE,
_DEVICE_WALL_MS) are the port's `dispatch.configure` and
`resilience.configure` arguments.

The reference's one real-device case (`test_real_device_batch_parity`,
slow there because of XLA's compile) runs here on the port's plain twin of
K11 against the JAX batch runner: verdicts, models and steps exact. The
port's own cases: an error that is not an injected fault (the card's
out-of-memory included) propagates instead of being answered by the CDCL,
and the configure settings' defaults are the JAX knobs'."""

import random
import time
from types import SimpleNamespace

import pytest
import torch

from mythril_tpu.parallel import jax_solver
from mythril_tpu.smt.solver import dispatch as jdispatch
from mythril_tpu.smt.solver import sat as jsat
from mythril_tpu.smt.solver import solver_statistics as jstatistics
from mythril_tpu.support import resilience as jresilience
from mythril_tpu.support import support_args as jsupport_args
from mythril_tpu.support import tpu_config
from mythril_tpu_torch.parallel import device_solver
from mythril_tpu_torch.smt.solver import dispatch as pdispatch
from mythril_tpu_torch.smt.solver import sat as psat
from mythril_tpu_torch.smt.solver import solver_statistics as pstatistics
from mythril_tpu_torch.support import resilience as presilience
from mythril_tpu_torch.support import support_args as psupport_args

JAX = SimpleNamespace(name="jax", dispatch=jdispatch, lane=jax_solver,
                      sat=jsat, stats=jstatistics.SolverStatistics,
                      resilience=jresilience, args=jsupport_args.args)
PORT = SimpleNamespace(name="port", dispatch=pdispatch, lane=device_solver,
                       sat=psat, stats=pstatistics.SolverStatistics,
                       resilience=presilience, args=psupport_args.args)
SIDES = (JAX, PORT)


def knobs(side, patch, flush=64, age_ms=60_000.0, cache=None,
          wall_ms=None) -> None:
    """The queue's flush threshold and age, the verdict cache's bound and
    the device wall budget: environment knobs on the JAX side,
    `configure` arguments on the port (its lane on the CPU)."""
    if side is JAX:
        patch.setenv("MYTHRIL_TPU_BATCH_FLUSH", str(flush))
        patch.setenv("MYTHRIL_TPU_BATCH_AGE_MS", str(age_ms))
        if cache is not None:
            patch.setenv("MYTHRIL_TPU_VERDICT_CACHE", str(cache))
        if wall_ms is not None:
            patch.setenv("MYTHRIL_TPU_DEVICE_WALL_MS", str(wall_ms))
        return
    pdispatch.configure(flush=flush, age_ms=age_ms, device="cpu",
                        **({} if cache is None else {"verdict_cache": cache}))
    if wall_ms is not None:
        presilience.configure(None, device_wall_ms=wall_ms)


def fresh(side) -> None:
    side.resilience.reset()
    side.stats().reset()
    side.dispatch.reset()
    side.args.device_crosscheck = 0
    side.args.batch_solve = True


def observe(case):
    """(port, jax) observations of one case, each side from fresh state
    with the reference fixture's knobs."""
    out = {}
    for side in SIDES:
        with pytest.MonkeyPatch.context() as patch:
            fresh(side)
            knobs(side, patch)
            try:
                out[side.name] = case(side, patch)
            finally:
                fresh(side)
                pdispatch.reset_settings()
    return out["port"], out["jax"]


class FakeDevice:
    """Python-DPLL stand-in for both device entry points, with a ledger."""

    def __init__(self, side, patch):
        self.single_calls = []
        self.batch_calls = []
        solve = side.sat.solve_cnf_python

        def single(clauses, n_vars, **kwargs):
            self.single_calls.append((clauses, n_vars))
            return solve(clauses, n_vars)

        def batch(queries, **kwargs):
            self.batch_calls.append(list(queries))
            return [solve(clauses, n_vars) for clauses, n_vars in queries]

        patch.setattr(side.lane, "solve_cnf_device", single)
        patch.setattr(side.lane, "solve_cnf_device_batch", batch)

    @property
    def queries_seen(self):
        return len(self.single_calls) + sum(len(batch)
                                            for batch in self.batch_calls)

    def ledger(self):
        return [self.single_calls, self.batch_calls]


def counters(side) -> dict:
    """The statistics and breaker the reference cases read."""
    stats = side.stats()
    health = side.resilience.registry.backend(side.resilience.DEVICE)
    batch = stats.batch_metrics() if stats.batch_submitted else {}
    batch.pop("amortized_ms_per_query", None)  # wall time
    return {"batch": batch,
            "submitted": stats.batch_submitted,
            "cache_hits": stats.batch_cache_hits,
            "dedup_hits": stats.batch_dedup_hits,
            "flushes": stats.batch_flushes,
            "flushed": stats.batch_flushed_queries,
            "device_queries": stats.device_queries,
            "device_solved": stats.device_solved,
            "fallbacks": stats.device_fallbacks,
            "skipped": stats.device_skipped,
            "failures": dict(stats.failure_counts),
            "breaker": health.state,
            "visits": dict(side.resilience.plan().site_counts),
            "cache": len(side.dispatch._QUEUE.cache),
            "pending": side.dispatch.pending_count()}


def satisfies(clauses, model):
    return all(any(model[abs(lit) - 1] == (lit > 0) for lit in clause)
               for clause in clauses)


def random_cnf(rng, n_vars=4, n_clauses=8):
    clauses = []
    for _ in range(n_clauses):
        cl_vars = rng.sample(range(1, n_vars + 1), 3)
        clauses.append([v if rng.random() < 0.5 else -v for v in cl_vars])
    return clauses, n_vars


# ---- canonicalization -----------------------------------------------------------------

def canonicalize_permutation_invariant(s, patch):
    a = s.dispatch.canonicalize([[2, 1], [-3, 1], [1, 2]], 3)
    b = s.dispatch.canonicalize([[1, -3], [1, 2, 2]], 3)
    assert a == b and a[0] == 3
    return a


def canonicalize_drops_tautologies(s, patch):
    got = [s.dispatch.canonicalize([[1, -1], [2]], 2),
           s.dispatch.canonicalize([[1, -1]], 2)]
    assert got == [(2, ((2,),)), (2, ())]
    return got


def canonicalize_empty_clause_collapses_to_falsum(s, patch):
    got = [s.dispatch.canonicalize([[1, 2], []], 2),
           s.dispatch.canonicalize([[]], 7)]
    assert got == [(2, ((),)), (7, ((),))]
    return got


def canonicalize_preserves_variable_numbering(s, patch):
    clauses = [[4, -2], [2, 4]]
    n_vars, canonical = s.dispatch.canonicalize(clauses, 4)
    status, model = s.sat.solve_cnf_python([list(c) for c in canonical],
                                           n_vars)
    assert status == s.sat.SAT and satisfies(clauses, model)
    return [canonical, status, model]


# ---- queue: dedup, cache, flush triggers ------------------------------------------------

def in_flight_dedup_single_device_query(s, patch):
    device = FakeDevice(s, patch)
    f1 = s.dispatch.submit([[1, 2], [-1]], 2, 1000)
    f2 = s.dispatch.submit([[2, 1], [-1], [1, 2]], 2, 5000)
    pending = s.dispatch.pending_count()
    dedup = s.stats().batch_dedup_hits
    assert (pending, dedup) == (1, 1)
    assert f1.result() == f2.result() and f1.result()[0] == s.sat.SAT
    assert device.queries_seen == 1
    return [f1.result(), device.ledger(), counters(s)]


def dedup_merges_conflict_budgets_by_max(s, patch):
    FakeDevice(s, patch)
    s.dispatch.submit([[1]], 1, 100)
    s.dispatch.submit([[1]], 1, 9000)
    entry = next(iter(s.dispatch._QUEUE.pending.values()))
    assert entry.max_conflicts == 9000
    return [entry.max_conflicts, entry.clauses, counters(s)]


def verdict_cache_hit_skips_device(s, patch):
    device = FakeDevice(s, patch)
    first = s.dispatch.solve([[1, 2], [-1]], 2, 1000)
    again = s.dispatch.submit([[-1], [2, 1]], 2, 1000)
    assert first[0] == s.sat.SAT and again.done()
    status, model = again.result()
    assert status == s.sat.SAT and satisfies([[1, 2], [-1]], model)
    assert device.queries_seen == 1 and s.stats().batch_cache_hits == 1
    return [first, again.result(), device.ledger(), counters(s)]


def unknown_never_cached(s, patch):
    patch.setattr(s.lane, "solve_cnf_device",
                  lambda clauses, n_vars, **kwargs: (s.sat.UNKNOWN, None))
    first = s.dispatch.solve([[1]], 1, 10)
    assert s.dispatch._QUEUE.cache == {}
    device = FakeDevice(s, patch)
    again = s.dispatch.solve([[1]], 1, 10)
    assert again[0] == s.sat.SAT and device.queries_seen == 1
    return [first, again, device.ledger(), counters(s)]


def cache_lru_eviction(s, patch):
    knobs(s, patch, flush=1, cache=2)
    device = FakeDevice(s, patch)
    seen = []
    for cnf in ([[1]], [[2], [1]], [[3], [2], [1]]):
        assert s.dispatch.solve(cnf, 3, 1000)[0] == s.sat.SAT
    seen.append(device.queries_seen)
    cache = len(s.dispatch._QUEUE.cache)
    s.dispatch.solve([[3], [2], [1]], 3, 1000)
    seen.append(device.queries_seen)
    s.dispatch.solve([[1]], 3, 1000)
    seen.append(device.queries_seen)
    assert seen == [3, 3, 4] and cache == 2
    return [seen, cache, device.ledger(), counters(s)]


def flush_threshold_triggers_batch(s, patch):
    knobs(s, patch, flush=2)
    device = FakeDevice(s, patch)
    f1 = s.dispatch.submit([[1]], 1, 1000)
    before = s.dispatch.pending_count()
    f2 = s.dispatch.submit([[1, 2], [-2]], 2, 1000)
    assert before == 1 and s.dispatch.pending_count() == 0
    assert f1.done() and f2.done()
    assert len(device.batch_calls) == 1 and len(device.batch_calls[0]) == 2
    assert (s.stats().batch_flushes, s.stats().batch_flushed_queries) == (1, 2)
    return [f1.result(), f2.result(), device.ledger(), counters(s)]


def age_threshold_triggers_flush(s, patch):
    knobs(s, patch, age_ms=0)
    device = FakeDevice(s, patch)
    future = s.dispatch.submit([[1]], 1, 1000)
    assert future.done() and s.dispatch.pending_count() == 0
    assert device.queries_seen == 1
    return [future.result(), device.ledger(), counters(s)]


def reset_fails_dangling_futures_closed(s, patch):
    FakeDevice(s, patch)
    future = s.dispatch.submit([[1]], 1, 1000)
    s.dispatch.reset()
    assert future.result() == (s.sat.UNKNOWN, None)
    assert s.dispatch._QUEUE.cache == {}
    return [future.result(), counters(s)]


# ---- bucket-padding / size edges --------------------------------------------------------

def batch_runner_trivial_and_oversize_edges(s, patch):
    """The batch runner's host fast paths: no device work at all."""
    big = [[1, 2], [-1, 2], [1, -2]]
    kwargs = {"device": "cpu"} if s is PORT else {}
    results = s.lane.solve_cnf_device_batch(
        [([], 3), ([[]], 2), (big, 2)], clause_cap=2, **kwargs)
    empty = s.lane.solve_cnf_device_batch([], **kwargs)
    assert results == [(s.sat.SAT, [False] * 3), (s.sat.UNSAT, None),
                       (s.sat.UNKNOWN, None)] and empty == []
    return [results, empty]


def dispatch_trivial_cnfs_answer_on_host(s, patch):
    """Through the whole dispatch path onto the real entry points."""
    got = [s.dispatch.solve([], 3, 1000), s.dispatch.solve([[]], 2, 1000),
           s.dispatch.solve([[1, 2], []], 2, 1000)]
    assert got == [(s.sat.SAT, [False] * 3), (s.sat.UNSAT, None),
                   (s.sat.UNSAT, None)]
    return [got, counters(s)]


def oversize_batch_returns_unknown_via_module_cap(s, patch):
    """The multi-entry path reads the lane's DEFAULT_CLAUSE_CAP at call
    time: patching the module global caps the real batch runner."""
    patch.setattr(s.lane, "DEFAULT_CLAUSE_CAP", 2)
    f1 = s.dispatch.submit([[1, 2], [-1, 2], [1, -2]], 2, 1000)
    f2 = s.dispatch.submit([[3, 4], [-3, 4], [3, -4]], 4, 1000)
    s.dispatch.flush()
    assert f1.result() == f2.result() == (s.sat.UNKNOWN, None)
    assert s.stats().device_fallbacks == 2
    assert s.dispatch._QUEUE.cache == {}
    return [f1.result(), counters(s)]


# ---- resilience contract ----------------------------------------------------------------

def one_breaker_visit_per_batch(s, patch):
    """N queries in one flush are ONE fire(DEVICE) visit."""
    device = FakeDevice(s, patch)
    s.resilience.configure("device_oom:1")
    try:
        futures = [s.dispatch.submit([[v]], v, 1000) for v in range(1, 4)]
        s.dispatch.flush()
        results = [f.result() for f in futures]
        assert results == [(s.sat.UNKNOWN, None)] * 3
        assert device.queries_seen == 0
        health = s.resilience.registry.backend(s.resilience.DEVICE)
        assert health.failure_counts == {s.resilience.DEVICE_OOM: 1}
        assert s.stats().device_fallbacks == 3
        assert health.state == s.resilience.CLOSED
        after = s.dispatch.solve([[1]], 1, 1000)
        assert after[0] == s.sat.SAT and device.queries_seen == 1
        return [results, after, dict(health.failure_counts),
                device.ledger(), counters(s)]
    finally:
        s.resilience.configure(None)


def wall_budget_divided_by_occupancy(s, patch):
    knobs(s, patch, wall_ms=40)

    def slow_batch(queries, **kwargs):
        time.sleep(0.08)  # 80 ms / 8 queries = 10 ms a query, budget 40
        return [s.sat.solve_cnf_python(clauses, n_vars)
                for clauses, n_vars in queries]

    patch.setattr(s.lane, "solve_cnf_device_batch", slow_batch)
    futures = [s.dispatch.submit([[v]], v, 1000) for v in range(1, 9)]
    s.dispatch.flush()
    results = [f.result() for f in futures]
    assert all(status == s.sat.SAT for status, _ in results)
    health = s.resilience.registry.backend(s.resilience.DEVICE)
    assert s.resilience.WALL_OVERRUN not in health.failure_counts
    return [results, dict(health.failure_counts), counters(s)]


def wall_budget_still_trips_on_slow_single_query(s, patch):
    knobs(s, patch, wall_ms=40)

    def slow_single(clauses, n_vars, **kwargs):
        time.sleep(0.08)  # 80 ms / 1 query: over budget
        return s.sat.solve_cnf_python(clauses, n_vars)

    patch.setattr(s.lane, "solve_cnf_device", slow_single)
    result = s.dispatch.solve([[1]], 1, 1000)
    assert result[0] == s.sat.SAT
    health = s.resilience.registry.backend(s.resilience.DEVICE)
    assert health.failure_counts.get(s.resilience.WALL_OVERRUN) == 1
    return [result, dict(health.failure_counts), counters(s)]


def quarantine_purges_verdict_cache(s, patch):
    device = FakeDevice(s, patch)
    cnf = [[1, 2], [-1]]
    first = s.dispatch.solve(cnf, 2, 1000)
    assert first[0] == s.sat.SAT and len(s.dispatch._QUEUE.cache) == 1
    s.resilience.registry.backend(s.resilience.DEVICE).quarantine("test")
    refused = [s.dispatch.solve([[2]], 2, 1000), s.dispatch.solve(cnf, 2,
                                                                  1000)]
    assert refused == [(s.sat.UNKNOWN, None)] * 2
    assert s.dispatch._QUEUE.cache == {} and device.queries_seen == 1
    assert s.stats().device_skipped == 2
    return [first, refused, device.ledger(), counters(s)]


# ---- parity: batched vs sequential, --no-batch-solve A/B --------------------------------

def batched_matches_sequential_verdicts(s, patch):
    rng = random.Random(1337)
    corpus = [random_cnf(rng) for _ in range(10)]
    corpus += [corpus[2], corpus[5]]  # repeats: dedup and cache
    expected = [s.sat.solve_cnf_python(clauses, n_vars)[0]
                for clauses, n_vars in corpus]
    assert s.sat.SAT in expected
    device = FakeDevice(s, patch)
    futures = [s.dispatch.submit(clauses, n_vars, 100000)
               for clauses, n_vars in corpus]
    results = [f.result() for f in futures]
    assert [status for status, _ in results] == expected
    for (clauses, _), (status, model) in zip(corpus, results):
        if status == s.sat.SAT:
            assert satisfies(clauses, model)
    statistics = s.stats()
    assert device.queries_seen <= 10 and statistics.batch_submitted == 12
    assert statistics.batch_cache_hits + statistics.batch_dedup_hits >= 2
    metrics = statistics.batch_metrics()
    assert metrics["flushed_queries"] == device.queries_seen
    assert metrics["occupancy"] >= 1.0 and metrics["cache_hit_rate"] >= 0.0
    return [results, device.ledger(), counters(s)]


def no_batch_solve_ab_parity(s, patch):
    rng = random.Random(99)
    corpus = [random_cnf(rng) for _ in range(6)]
    device = FakeDevice(s, patch)
    batched = [s.dispatch.solve(clauses, n_vars, 100000)[0]
               for clauses, n_vars in corpus]
    s.dispatch.reset()
    s.stats().reset()
    s.args.batch_solve = False
    sequential = [s.dispatch.solve(clauses, n_vars, 100000)[0]
                  for clauses, n_vars in corpus]
    assert sequential == batched
    statistics = s.stats()
    assert (statistics.batch_submitted, statistics.batch_flushes) == (0, 0)
    assert s.dispatch._QUEUE.cache == {}
    s.dispatch.solve(corpus[0][0], corpus[0][1], 100000)
    s.dispatch.solve(corpus[0][0], corpus[0][1], 100000)
    assert len(device.single_calls) == 6 + 6 + 2
    return [batched, sequential, device.ledger(), counters(s)]


CASES = [canonicalize_permutation_invariant, canonicalize_drops_tautologies,
         canonicalize_empty_clause_collapses_to_falsum,
         canonicalize_preserves_variable_numbering,
         in_flight_dedup_single_device_query,
         dedup_merges_conflict_budgets_by_max, verdict_cache_hit_skips_device,
         unknown_never_cached, cache_lru_eviction,
         flush_threshold_triggers_batch, age_threshold_triggers_flush,
         reset_fails_dangling_futures_closed,
         batch_runner_trivial_and_oversize_edges,
         dispatch_trivial_cnfs_answer_on_host,
         oversize_batch_returns_unknown_via_module_cap,
         one_breaker_visit_per_batch, wall_budget_divided_by_occupancy,
         wall_budget_still_trips_on_slow_single_query,
         quarantine_purges_verdict_cache, batched_matches_sequential_verdicts,
         no_batch_solve_ab_parity]


@pytest.mark.parametrize("case", CASES, ids=lambda case: case.__name__)
def test_dispatch_case(case):
    """A case of tests/test_batch_dispatch.py on both packages."""
    got, want = observe(case)
    assert got == want


def test_real_device_batch_parity():
    """The reference's real-device batch (n_probes 4, max_steps 4000,
    chunk 8) on the port's plain twin of K11 against the JAX batch runner:
    the same verdicts and models, each checked against the Python DPLL's
    verdict, after the same number of steps, in the same buckets."""
    rng = random.Random(7)
    corpus = [random_cnf(rng, n_vars=3, n_clauses=5) for _ in range(6)]
    corpus.append(([[1], [-1]], 1))  # one guaranteed UNSAT
    steps = {"jax": 0, "port": 0}
    run_accounted = jax_solver._run_accounted
    run_chunk = device_solver.run_chunk

    def jax_chunk(*args, **kwargs):
        steps["jax"] += 8
        return run_accounted(*args, **kwargs)

    def port_chunk(*args, **kwargs):
        steps["port"] += 8
        return run_chunk(*args, **kwargs)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    shapes = {}
    try:
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jax_solver, "_run_accounted", jax_chunk)
            patch.setattr(device_solver, "run_chunk", port_chunk)
            for side, kwargs in ((JAX, {}), (PORT, {"device": "cpu"})):
                side.stats().reset()
                results = side.lane.solve_cnf_device_batch(
                    corpus, n_probes=4, max_steps=4000, chunk=8, **kwargs)
                shapes[side.name] = (results,
                                     sorted(side.stats().batch_bucket_shapes))
    finally:
        torch.set_num_threads(threads)
        for side in SIDES:
            side.stats().reset()
    assert shapes["port"] == shapes["jax"]
    assert steps["port"] == steps["jax"] > 0
    for (clauses, n_vars), (status, model) in zip(corpus,
                                                  shapes["port"][0]):
        assert status == psat.solve_cnf_python(clauses, n_vars)[0]
        if status == psat.SAT:
            assert satisfies(clauses, model)


def test_lane_defects_propagate():
    """A solve that fails for another reason than an injected fault (a
    kernel that does not build, a launch that fails, the card out of
    memory) raises through the dispatch: it is not classified, the breaker
    records nothing, and no query is answered on the CDCL in its place.
    Only the plain twin's host `MemoryError` on the CPU lane is classified,
    as the reference classifies its stub's."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel build failed:\nsat_step.cu: error")

    def raising(error):
        def solve(*args, **kwargs):
            raise error
        return solve

    with pytest.MonkeyPatch.context() as patch:
        fresh(PORT)
        knobs(PORT, patch, flush=2)
        patch.setattr(device_solver, "solve_cnf_device", broken)
        patch.setattr(device_solver, "solve_cnf_device_batch", broken)
        try:
            with pytest.raises(RuntimeError, match="kernel build failed"):
                pdispatch.solve([[1]], 1, 1000)
            pdispatch.submit([[1]], 1, 1000)
            with pytest.raises(RuntimeError, match="kernel build failed"):
                pdispatch.submit([[2]], 2, 1000)
            health = presilience.registry.backend(presilience.DEVICE)
            assert (health.state, health.failure_counts) == (
                presilience.CLOSED, {})
            assert pstatistics.SolverStatistics().device_fallbacks == 0
            # the card out of memory is not answered on the host either
            patch.setattr(device_solver, "solve_cnf_device", raising(
                torch.cuda.OutOfMemoryError("CUDA out of memory")))
            with pytest.raises(torch.cuda.OutOfMemoryError):
                pdispatch.solve([[3]], 3, 1000)
            # nor is a host MemoryError on the card's lane
            patch.setattr(device_solver, "solve_cnf_device",
                          raising(MemoryError("host")))
            pdispatch.configure(flush=2, device="cuda")
            with pytest.raises(MemoryError):
                pdispatch.solve([[4]], 4, 1000)
            assert (health.state, health.failure_counts) == (
                presilience.CLOSED, {})
            assert pstatistics.SolverStatistics().device_fallbacks == 0
            # the twin's MemoryError on the CPU lane is classified
            pdispatch.configure(flush=2, device="cpu")
            assert pdispatch.solve([[5]], 5, 1000) == (psat.UNKNOWN, None)
            assert health.failure_counts == {presilience.DEVICE_OOM: 1}
        finally:
            fresh(PORT)
            pdispatch.reset_settings()


def test_settings_follow_the_jax_knobs():
    """`configure`'s defaults are the JAX knobs' (tpu_config.py), read at
    call time; `reset_settings` restores them; the lane's device is the
    card unless a test names the CPU."""
    defaults = {name: tpu_config.REGISTRY[name].default for name in (
        "MYTHRIL_TPU_BATCH_FLUSH", "MYTHRIL_TPU_BATCH_AGE_MS",
        "MYTHRIL_TPU_VERDICT_CACHE", "MYTHRIL_TPU_DEVICE_CLAUSE_CAP")}
    pdispatch.reset_settings()
    assert (pdispatch.flush_threshold(), pdispatch.flush_age_ms(),
            pdispatch.cache_size(), pdispatch._settings["clause_cap"]) == \
        tuple(defaults.values())
    assert pdispatch.MAX_DEVICE_STEPS == 50_000
    pdispatch.configure(flush=0, age_ms=5, verdict_cache=0, device="cpu")
    assert (pdispatch.flush_threshold(), pdispatch.flush_age_ms(),
            pdispatch.cache_size()) == (1, 5.0, 1)
    assert pdispatch.resolve_device() == torch.device("cpu")
    pdispatch.reset_settings()
    assert pdispatch._settings["device"] is None
