"""The port's SMT façade and host solver stack (mythril_tpu_torch/smt,
smt/solver/{sat,incremental,solver,independence_solver}, support/model)
against the JAX package's, on the cases of tests/test_smt.py,
tests/test_incremental.py and the check_formulas cases of
tests/test_simplify.py, plus get_model and the `--solver jax` refusal.

Each case is written once over a `Side` (one package's modules) and runs
on both packages from a fresh solver backend, with the reference test's
own assertions inside. It returns what it observed in two parts:

- `same`: verdicts, folded constants, forced values and optima. These must
  be equal between the packages, always.
- `model`: the values the CDCL happened to pick. These must be equal
  wherever the two packages blasted the same clause pool, in the same
  order: the two CDCL libraries are one C++ source, so the same pool and
  assumptions give the same model. terms.py orders commutative operands by
  a hash of their children's ids, so a deeper formula can blast in a
  different order in the two packages (ROADMAP C); there, each model is
  held only to the case's own assertions, which every case makes."""

import itertools
import random
import re
import time
from types import SimpleNamespace

import pytest
import torch

import mythril_tpu.smt as jsmt
from mythril_tpu import exceptions as jexceptions
from mythril_tpu.core import time_handler as jtime_handler
from mythril_tpu.smt import smtlib as jsmtlib
from mythril_tpu.smt.solver import incremental as jincremental
from mythril_tpu.smt.solver import independence_solver as jindependence
from mythril_tpu.smt.solver import bitblast as jbitblast
from mythril_tpu.smt.solver import preprocess as jpreprocess
from mythril_tpu.smt.solver import sat as jsat
from mythril_tpu.smt.solver import simplify as jsimplify
from mythril_tpu.smt.solver import solver as jsolver
from mythril_tpu.smt.solver import solver_statistics as jstatistics
from mythril_tpu.support import model as jmodel
from mythril_tpu.support import support_args as jsupport_args
import mythril_tpu_torch.smt as psmt
from mythril_tpu_torch import exceptions as pexceptions
from mythril_tpu_torch.core import time_handler as ptime_handler
from mythril_tpu_torch.parallel import device_solver
from mythril_tpu_torch.smt import smtlib as psmtlib
from mythril_tpu_torch.smt.solver import incremental as pincremental
from mythril_tpu_torch.smt.solver import independence_solver as pindependence
from mythril_tpu_torch.smt.solver import bitblast as pbitblast
from mythril_tpu_torch.smt.solver import preprocess as ppreprocess
from mythril_tpu_torch.smt.solver import sat as psat
from mythril_tpu_torch.smt.solver import simplify as psimplify
from mythril_tpu_torch.smt.solver import solver as psolver
from mythril_tpu_torch.smt.solver import solver_statistics as pstatistics
from mythril_tpu_torch.support import model as pmodel
from mythril_tpu_torch.support import support_args as psupport_args

def twin_solve(clauses, n_vars):
    """`solve_cnf_device` on the CPU twin, on one thread: its many small
    ops, in several test workers at once, otherwise spin on each other's
    cores (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return device_solver.solve_cnf_device(clauses, n_vars, device="cpu")
    finally:
        torch.set_num_threads(threads)


JAX = SimpleNamespace(
    name="jax", smt=jsmt, terms=jsmt.terms, smtlib=jsmtlib, sat=jsat,
    solver=jsolver, incremental=jincremental, independence=jindependence,
    simplify=jsimplify, preprocess=jpreprocess, bitblast=jbitblast,
    stats=jstatistics.SolverStatistics, model=jmodel,
    args=jsupport_args.args, time_handler=jtime_handler.time_handler,
    exceptions=jexceptions,
    # the reference test's stand-in for the device DPLL: the host CDCL
    device=lambda clauses, n_vars, _budget: jsat.solve_cnf(clauses, n_vars))
PORT = SimpleNamespace(
    name="port", smt=psmt, terms=psmt.terms, smtlib=psmtlib, sat=psat,
    solver=psolver, incremental=pincremental, independence=pindependence,
    simplify=psimplify, preprocess=ppreprocess, bitblast=pbitblast,
    stats=pstatistics.SolverStatistics, model=pmodel,
    args=psupport_args.args, time_handler=ptime_handler.time_handler,
    exceptions=pexceptions,
    # the port's device SAT lane, its plain twin on the CPU
    device=lambda clauses, n_vars, _budget: twin_solve(clauses, n_vars))


def fresh(side) -> None:
    side.solver.reset_solver_backend()
    side.stats().reset()
    side.simplify.reset_simplify_memo()


def pool(side):
    pipeline = side.solver._pipeline
    return None if pipeline is None else pipeline.blaster.clauses


def run_both(case, *args):
    """(port, jax) observations of one case, each from a fresh backend."""
    observed = {}
    for side in (JAX, PORT):
        fresh(side)
        out = case(side, *args)
        observed[side.name] = (out, pool(side))
        fresh(side)
    return observed["port"], observed["jax"]


def assert_parity(case, *args):
    (got, got_pool), (want, want_pool) = run_both(case, *args)
    assert got["same"] == want["same"]
    if got_pool == want_pool:
        assert got.get("model") == want.get("model")


def bv(s, value, width=8):
    return s.smt.symbol_factory.BitVecVal(value, width)


def sym(s, name, width=8):
    return s.smt.symbol_factory.BitVecSym(name, width)


def tokens(text: str) -> list:
    """An SMT-LIB text's tokens, sorted: the text up to the order of
    commutative operands, which depends on the process (ROADMAP C)."""
    return sorted(re.findall(r"[()]|[^\s()]+", text))


# ---- tests/test_smt.py: the term IR ------------------------------------------------

def smt_constant_folding(s):
    x = sym(s, "x")
    values = [(bv(s, 3) + bv(s, 5)).value, (bv(s, 250) + bv(s, 10)).value,
              (bv(s, 3) * bv(s, 0)).value, (x * 0).value, (x - x).value,
              (bv(s, 7) / bv(s, 0)).value, s.smt.URem(bv(s, 7), bv(s, 0)).value]
    assert values == [8, 4, 0, 0, 0, 255, 7]
    assert (x + 0).raw is x.raw
    return {"same": values}


def smt_hash_consing(s):
    x, y = sym(s, "x"), sym(s, "y")
    assert (x + y).raw is (x + y).raw
    assert (x + y).raw is (y + x).raw
    return {"same": tokens(s.smtlib.to_smt2([(x + y == 3).raw]))}


def smt_annotations_propagate(s):
    x = sym(s, "x")
    x.annotate("taint")
    y = x + 5
    z = s.smt.If(y == 3, bv(s, 1), bv(s, 0))
    assert "taint" in y.annotations and "taint" in z.annotations
    return {"same": [sorted(y.annotations), sorted(z.annotations)]}


def smt_signed_semantics(s):
    values = [(bv(s, 0x80) / bv(s, 0xFF)).value, (bv(s, 0xF8) % bv(s, 3)).value,
              (bv(s, 0xF8) >> 1).value]
    assert values == [0x80, (-8 % 3 - 3) % 256, 0xFC]
    return {"same": values}


def smt_extract_concat_rewrites(s):
    x = sym(s, "x", 16)
    hi_lo = s.smt.Concat(sym(s, "hi"), sym(s, "lo"))
    assert s.smt.Extract(7, 0, hi_lo).raw is sym(s, "lo").raw
    assert s.smt.Extract(15, 8, hi_lo).raw is sym(s, "hi").raw
    assert s.smt.Extract(15, 0, x).raw is x.raw
    return {"same": tokens(s.smtlib.to_smt2([(hi_lo == 0x1234).raw]))}


def smt_select_over_store(s):
    array = s.smt.Array("storage", 8, 8)
    array[5] = 42
    array[6] = 43
    index = sym(s, "i")
    values = [array[5].value, array[6].value]
    array[index] = 9
    values += [array[index].value, s.smt.K(8, 8, 7)[3].value]
    assert values == [42, 43, 9, 7]
    return {"same": values}


# ---- tests/test_smt.py: the solver -------------------------------------------------

def smt_simple_sat_model(s):
    x = sym(s, "x")
    solver = s.smt.Solver()
    solver.add(x == 42)
    status = solver.check()
    assert status == "sat" and solver.model().eval(x) == 42
    return {"same": [status, solver.model().eval(x)]}


def smt_unsat(s):
    x = sym(s, "x")
    solver = s.smt.Solver()
    solver.add(x == 1, x == 2)
    assert solver.check() == "unsat"
    return {"same": ["unsat"]}


def smt_mul_add_relation(s):
    x, y = sym(s, "x"), sym(s, "y")
    solver = s.smt.Solver()
    solver.add(x * y == 35, s.smt.UGT(x, 1), s.smt.UGT(y, 1), s.smt.ULT(x, y))
    status = solver.check()
    assert status == "sat"
    model = solver.model()
    assert model.eval(x) * model.eval(y) % 256 == 35
    assert 1 < model.eval(x) < model.eval(y)
    return {"same": [status], "model": [model.eval(x), model.eval(y)]}


def smt_division_by_symbolic(s):
    x = sym(s, "x")
    solver = s.smt.Solver()
    solver.add(s.smt.UDiv(bv(s, 100), x) == 12)
    status = solver.check()
    assert status == "sat" and 100 // solver.model().eval(x) == 12
    return {"same": [status], "model": [solver.model().eval(x)]}


def smt_shift_out_of_range(s):
    x = sym(s, "x")
    solver = s.smt.Solver()
    solver.add(bv(s, 1) << x == 0, s.smt.ULT(x, 200))
    status = solver.check()
    assert status == "sat" and solver.model().eval(x) >= 8
    return {"same": [status], "model": [solver.model().eval(x)]}


def smt_array_reasoning(s):
    array = s.smt.Array("store", 8, 8)
    i, j = sym(s, "i"), sym(s, "j")
    solver = s.smt.Solver()
    solver.add(array[i] == 1, array[j] == 2, i == j)
    first = solver.check()
    solver2 = s.smt.Solver()
    solver2.add(array[i] == 1, array[j] == 2)
    second = solver2.check()
    assert (first, second) == ("unsat", "sat")
    model = solver2.model()
    assert model.eval(i) != model.eval(j)
    return {"same": [first, second], "model": [model.eval(i), model.eval(j)]}


def smt_uninterpreted_function_congruence(s):
    f = s.smt.Function("f", [8], 8)
    x, y = sym(s, "x"), sym(s, "y")
    solver = s.smt.Solver()
    solver.add(x == y, s.smt.Not(f(x) == f(y)))
    solver2 = s.smt.Solver()
    solver2.add(f(x) == 3, f(y) == 4)
    statuses = [solver.check(), solver2.check()]
    assert statuses == ["unsat", "sat"]
    model = solver2.model()
    return {"same": statuses + [model.eval(f(x)), model.eval(f(y))],
            "model": [model.eval(x), model.eval(y)]}


def smt_optimize_minimize(s):
    x = sym(s, "x")
    optima = []
    for objective in ("minimize", "maximize"):
        optimizer = s.smt.Optimize()
        optimizer.add(s.smt.UGT(x, 9), s.smt.ULT(x, 100))
        getattr(optimizer, objective)(x)
        assert optimizer.check() == "sat"
        optima.append(optimizer.model().eval(x))
    assert optima == [10, 99]
    return {"same": optima}


def smt_independence_solver_partitions(s):
    x, y, z, w = sym(s, "x"), sym(s, "y"), sym(s, "z"), sym(s, "w")
    buckets = s.independence.partition([(x == y).raw, (y == 3).raw,
                                        (z == w).raw])
    assert len(buckets) == 2
    solver = s.smt.IndependenceSolver()
    solver.add(x == y, y == 3, z == w, w == 9)
    status = solver.check()
    model = solver.model()
    assert status == "sat" and (model.eval(x), model.eval(z)) == (3, 9)
    return {"same": [[len(b) for b in buckets], status, model.eval(x),
                     model.eval(y), model.eval(z), model.eval(w)]}


def smt_256_bit_path_constraint(s):
    calldata_word = s.smt.symbol_factory.BitVecSym("calldata_0", 256)
    balance = s.smt.symbol_factory.BitVecSym("balance", 256)
    selector = s.smt.Extract(255, 224, calldata_word)
    solver = s.smt.Solver()
    solver.add(selector == 0x3CCFD60B)
    solver.add(s.smt.UGT(balance, 10 ** 18))
    status = solver.check()
    model = solver.model()
    assert status == "sat"
    assert model.eval(calldata_word) >> 224 == 0x3CCFD60B
    assert model.eval(balance) > 10 ** 18
    return {"same": [status, model.eval(calldata_word) >> 224],
            "model": [model.eval(calldata_word), model.eval(balance)]}


def _random_formula(s, rng, variables, depth):
    if depth == 0:
        if rng.random() < 0.5:
            return rng.choice(variables)
        return s.smt.symbol_factory.BitVecVal(rng.randrange(16), 4)
    a = _random_formula(s, rng, variables, depth - 1)
    b = _random_formula(s, rng, variables, depth - 1)
    op = rng.choice(["add", "sub", "mul", "and", "or", "xor", "udiv", "urem",
                     "shl", "lshr"])
    return {"add": lambda: a + b, "sub": lambda: a - b, "mul": lambda: a * b,
            "and": lambda: a & b, "or": lambda: a | b, "xor": lambda: a ^ b,
            "udiv": lambda: s.smt.UDiv(a, b), "urem": lambda: s.smt.URem(a, b),
            "shl": lambda: a << b, "lshr": lambda: s.smt.LShR(a, b)}[op]()


def smt_differential_vs_bruteforce(s):
    """40 random 4-bit formulas: the verdict against enumeration, the model
    against the formula."""
    rng = random.Random(1234)
    x4 = s.smt.symbol_factory.BitVecSym("dx", 4)
    y4 = s.smt.symbol_factory.BitVecSym("dy", 4)
    statuses, models = [], []
    for trial in range(40):
        lhs = _random_formula(s, rng, [x4, y4], 2)
        target = rng.randrange(16)
        truth = any(s.terms.evaluate(lhs.raw, {x4.raw: vx, y4.raw: vy}) == target
                    for vx, vy in itertools.product(range(16), repeat=2))
        status, model = s.solver.check_formulas([(lhs == target).raw])
        assert status == ("sat" if truth else "unsat"), trial
        statuses.append(status)
        if truth:
            values = {x4.raw: model.eval(x4), y4.raw: model.eval(y4)}
            assert s.terms.evaluate(lhs.raw, values) == target, trial
            models.append((values[x4.raw], values[y4.raw]))
    return {"same": statuses, "model": models}


def smt_smtlib_dump(s):
    x = sym(s, "x")
    text = s.smtlib.to_smt2([(x + 1 == 5).raw])
    assert "(set-logic QF_AUFBV)" in text
    assert "declare-fun" in text and "check-sat" in text
    return {"same": tokens(text)}


SMT_CASES = [smt_constant_folding, smt_hash_consing, smt_annotations_propagate,
             smt_signed_semantics, smt_extract_concat_rewrites,
             smt_select_over_store, smt_simple_sat_model, smt_unsat,
             smt_mul_add_relation, smt_division_by_symbolic,
             smt_shift_out_of_range, smt_array_reasoning,
             smt_uninterpreted_function_congruence, smt_optimize_minimize,
             smt_independence_solver_partitions, smt_256_bit_path_constraint,
             smt_differential_vs_bruteforce, smt_smtlib_dump]


@pytest.mark.parametrize("case", SMT_CASES, ids=lambda c: c.__name__[4:])
def test_smt_case(case):
    """A case of tests/test_smt.py on both packages: its assertions hold in
    each, and the observations agree."""
    assert_parity(case)


def test_smt_dump_parses_back_in_the_port():
    """A JAX façade's constraint set crosses to the port as SMT-LIB text and
    decides the same there."""
    x, y = sym(JAX, "x"), sym(JAX, "y")
    constraints = [(x * y == 35).raw, JAX.smt.UGT(x, 1).raw,
                   JAX.smt.ULT(x, y).raw, JAX.smt.UGT(y, 1).raw]
    parsed = PORT.smtlib.from_smt2(JAX.smtlib.to_smt2(constraints))
    assert len(parsed) == len(constraints)
    fresh(PORT)
    status, model = PORT.solver.check_formulas(parsed)
    assert status == JAX.solver.check_formulas(constraints)[0] == "sat"
    assert all(model.eval(c) is True for c in parsed)


# ---- tests/test_incremental.py -------------------------------------------------------

def sym256(s, name, width=256):
    return s.smt.symbol_factory.BitVecSym(name, width)


def inc_growing_prefix_statuses(s):
    x = sym256(s, "inc_x")
    base = [s.smt.UGT(x, 5), s.smt.ULT(x, 100)]
    statuses, values = [], []
    for extra in ([], [x == 50], [x == 200], [x == 99], [x == 5]):
        solver = s.smt.Solver(timeout=20_000)
        solver.add(*base, *extra)
        statuses.append(solver.check())
        if statuses[-1] == "sat":
            values.append(solver.model().eval(x))
            assert 5 < values[-1] < 100
    assert statuses == ["sat", "sat", "unsat", "sat", "unsat"]
    return {"same": statuses + values[1:], "model": values[:1]}


def inc_pool_is_shared_across_queries(s):
    y = sym256(s, "inc_shared_y")
    solver = s.smt.Solver(timeout=20_000)
    solver.add(y * 3 == 99)
    first = solver.check()
    pipeline = s.solver._get_pipeline()
    vars_after_first = pipeline.blaster.n_vars
    solver2 = s.smt.Solver(timeout=20_000)
    solver2.add(y * 3 == 99, s.smt.ULT(y, 1 << 128))
    second = solver2.check()
    grown = pipeline.blaster.n_vars - vars_after_first
    assert (first, second) == ("sat", "sat")
    assert grown < 2000, f"re-blasted the shared prefix (+{grown} vars)"
    return {"same": [first, second, vars_after_first, grown,
                     solver2.model().eval(y)]}


def inc_arrays_consistent_across_queries(s):
    storage = s.smt.Array("inc_storage", 256, 256)
    index = sym256(s, "inc_idx")
    value = storage[index]
    solver = s.smt.Solver(timeout=20_000)
    solver.add(value == 7, index == 3)
    other = storage[sym256(s, "inc_idx2")]
    solver2 = s.smt.Solver(timeout=20_000)
    solver2.add(value == 7, other == 9, index == sym256(s, "inc_idx2"))
    statuses = [solver.check(), solver2.check()]
    assert statuses == ["sat", "unsat"]
    return {"same": statuses}


def inc_model_array_reconstruction(s):
    storage = s.smt.Array("inc_store2", 256, 256)
    index = sym256(s, "inc_i3")
    solver = s.smt.Solver(timeout=20_000)
    solver.add(storage[index] == 42, index == 5)
    status = solver.check()
    table = solver.model().arrays.get(storage.raw, {})
    assert status == "sat" and table.get(5) == 42
    return {"same": [status, sorted(table.items())]}


def inc_push_pop_scoping(s):
    z = sym256(s, "inc_pp_z")
    solver = s.smt.Solver(timeout=20_000)
    solver.add(s.smt.UGT(z, 10))
    solver.push()
    solver.add(s.smt.ULT(z, 5))
    inner = solver.check()
    solver.pop()
    kept = len(solver.constraints)
    outer = solver.check()
    value = solver.model().eval(z)
    solver.pop()
    assert (inner, kept, outer) == ("unsat", 1, "sat") and value > 10
    assert solver.constraints == []
    return {"same": [inner, kept, outer], "model": [value]}


def inc_selector_pattern_sequence(s):
    word = sym256(s, "inc_calldata0")
    selector = s.smt.Extract(255, 224, word)
    seen = []
    for pinned in (0x11111111, 0x22222222, 0x33333333):
        solver = s.smt.Solver(timeout=20_000)
        solver.add(selector == pinned)
        assert solver.check() == "sat"
        seen.append(solver.model().eval(word) >> 224)
    assert seen == [0x11111111, 0x22222222, 0x33333333]
    return {"same": seen}


def inc_device_cone_extraction(s):
    """The device pre-pass sees the query's cone, not the pool: its clause
    and variable counts, and its verdict on the side's device stand-in (the
    port's: the K11 twin on the CPU)."""
    pipeline = s.solver._get_pipeline()
    heavy = sym256(s, "cone_heavy", 128)
    solver = s.smt.Solver(timeout=20_000)
    solver.add(heavy * heavy == 1 << 20)
    solver.check()
    pool_size = len(pipeline.blaster.clauses)
    calls = {}

    def probe(clauses, n_vars, max_conflicts):
        calls["cone"] = (len(clauses), n_vars)
        calls["verdict"] = s.device(clauses, n_vars, max_conflicts)[0]
        return s.sat.UNKNOWN, None  # punt to the CDCL session

    # 8 bits: the twin's DPLL, which learns nothing, decides it at once
    small = sym256(s, "cone_small", 8)
    status, _ = pipeline.check([s.smt.UGT(small, 5).raw,
                                s.smt.ULT(small, 9).raw], 100_000,
                               device_solve=probe)
    assert status == "sat" and calls["verdict"] == s.sat.SAT
    assert calls["cone"][0] < pool_size / 2
    return {"same": [status, calls["cone"], calls["verdict"], pool_size]}


def inc_device_cone_decisive_answers(s):
    """A SAT cone answer becomes the model; an UNSAT one is final (8 bits,
    as in inc_device_cone_extraction)."""
    pipeline = s.solver._get_pipeline()
    x = sym256(s, "cone_dec", 8)
    status, model = pipeline.check([s.smt.UGT(x, 7).raw, s.smt.ULT(x, 9).raw],
                                   100_000, device_solve=s.device)
    value = model.eval(x.raw)
    unsat, _ = pipeline.check([s.smt.UGT(x, 9).raw, s.smt.ULT(x, 9).raw],
                              100_000, device_solve=s.device)
    assert (status, value, unsat) == ("sat", 8, "unsat")
    return {"same": [status, value, unsat]}


INCREMENTAL_CASES = [inc_growing_prefix_statuses,
                     inc_pool_is_shared_across_queries,
                     inc_arrays_consistent_across_queries,
                     inc_model_array_reconstruction, inc_push_pop_scoping,
                     inc_selector_pattern_sequence, inc_device_cone_extraction,
                     inc_device_cone_decisive_answers]


@pytest.mark.parametrize("case", INCREMENTAL_CASES, ids=lambda c: c.__name__[4:])
def test_incremental_case(case):
    """A case of tests/test_incremental.py on both packages."""
    assert_parity(case)


def test_wall_clock_timeout_enforced():
    """The port's CDCL session honours a wall-clock deadline: a 64-bit
    factoring query under 500 ms ends well within 3 s."""
    pipeline = PORT.incremental.IncrementalPipeline()
    try:
        x, y = sym256(PORT, "tmo_x", 64), sym256(PORT, "tmo_y", 64)
        hard = [(x * y == 0xC96B_4D5E_9F83_1D21).raw, PORT.smt.UGT(x, 1).raw,
                PORT.smt.UGT(y, 1).raw, PORT.smt.ULT(x, 1 << 63).raw]
        start = time.perf_counter()
        status, _ = pipeline.check(hard, max_conflicts=1 << 40, timeout_ms=500)
        elapsed = time.perf_counter() - start
    finally:
        pipeline.close()
    assert elapsed < 3.0, f"deadline ignored: {elapsed:.1f}s for 500ms budget"
    assert status in ("unknown", "sat", "unsat")


# ---- tests/test_simplify.py: the check_formulas cases -------------------------------

def simp_constant_propagation_detects_conflict(s):
    x = s.terms.bv_var("x", 64)
    outcome = s.simplify.simplify_constraints([
        s.terms.bv_cmp("eq", x, s.terms.bv_const(5, 64)),
        s.terms.bv_cmp("eq", x, s.terms.bv_const(6, 64))])
    assert outcome.is_false
    status, _ = s.solver.check_formulas([
        s.terms.bv_cmp("eq", x, s.terms.bv_const(5, 64)),
        s.terms.bv_cmp("eq", x, s.terms.bv_const(6, 64))])
    assert status == "unsat"
    return {"same": [outcome.is_false, status]}


def simp_models_stay_complete_after_propagation(s):
    x, y = s.terms.bv_var("x", 64), s.terms.bv_var("y", 64)
    status, model = s.solver.check_formulas([
        s.terms.bv_cmp("eq", x, s.terms.bv_const(5, 64)),
        s.terms.bv_cmp("eq", y, s.terms.bv_binop("bvadd", x,
                                                 s.terms.bv_const(1, 64)))])
    assert (status, model.eval(x), model.eval(y)) == ("sat", 5, 6)
    return {"same": [status, model.eval(x), model.eval(y)]}


def _flag_array_query(t, n_stores=128, width=256, hits=(77,)):
    """tests/test_simplify.py's flag_array shape: a long concrete store chain
    over a const array, read at a symbolic index."""
    array = t.const_array(width, t.bv_const(0, width))
    for position in range(n_stores):
        array = t.store(array, t.bv_const(position, width),
                        t.bv_const(1 if position in hits else 2, width))
    return [t.bv_cmp("eq", t.select(array, t.bv_var("flag_index", width)),
                     t.bv_const(1, width))]


def simp_flag_array_witness_query_fast_and_small(s):
    conjuncts = _flag_array_query(s.terms)
    lowered, _ = s.preprocess.lower_constraints(list(conjuncts), simplify=False)
    blaster = s.bitblast.Blaster()
    for node in lowered:
        blaster.assert_true(node)
    raw_clauses = len(blaster.clauses)
    statistics = s.stats()
    started = time.time()
    status, model = s.solver.check_formulas(list(conjuncts))
    elapsed = time.time() - started
    index = model.eval(s.terms.bv_var("flag_index", 256))
    clauses = statistics.last_query_clauses
    assert (status, index) == ("sat", 77)
    assert elapsed < 5.0, f"witness query took {elapsed:.1f}s cold"
    assert 0 < clauses and raw_clauses >= 100 * clauses
    assert statistics.simplify_selects_bounded >= 1
    assert statistics.simplify_clauses_avoided > 0
    return {"same": [status, index, raw_clauses, clauses,
                     statistics.simplify_selects_bounded,
                     statistics.simplify_clauses_avoided]}


def simp_no_simplify_flag_respected(s):
    x = s.terms.bv_var("x", 64)
    s.args.simplify = False
    try:
        fresh(s)
        status, model = s.solver.check_formulas(
            [s.terms.bv_cmp("eq", x, s.terms.bv_const(5, 64))])
        rewrites = s.stats().simplify_rewrites
    finally:
        s.args.simplify = True
    assert (status, model.eval(x), rewrites) == ("sat", 5, 0)
    return {"same": [status, model.eval(x), rewrites]}


SIMPLIFY_CASES = [simp_constant_propagation_detects_conflict,
                  simp_models_stay_complete_after_propagation,
                  simp_flag_array_witness_query_fast_and_small,
                  simp_no_simplify_flag_respected]


@pytest.mark.parametrize("case", SIMPLIFY_CASES, ids=lambda c: c.__name__[5:])
def test_simplify_case(case):
    """A check_formulas case of tests/test_simplify.py on both packages."""
    assert_parity(case)


# ---- get_model -------------------------------------------------------------------------

def gm_optima(s):
    """Optima of small objectives: the first extreme probe closes the first
    three, the binary search the others."""
    x, y = sym(s, "gx"), sym(s, "gy")
    balance = sym256(s, "g_balance")
    cases = [([s.smt.UGT(x, 9), s.smt.ULT(x, 100)], (x,), ()),
             ([s.smt.UGT(x, 9), s.smt.ULT(x, 100)], (), (x,)),
             ([x + y == 20], (x,), (y,)),
             ([s.smt.UGT(balance, 10 ** 18)], (balance,), ()),
             ([s.smt.ULT(x, y), s.smt.UGT(x, 40), s.smt.ULT(y, 200)], (y,), (x,))]
    optima = []
    for constraints, minimize, maximize in cases:
        model = s.model.get_model(constraints, minimize=minimize,
                                  maximize=maximize)
        assert all(model.eval(c) is True for c in constraints)
        optima.append([model.eval(e) for e in minimize + maximize])
    assert optima[:4] == [[10], [99], [0, 20], [10 ** 18 + 1]]
    return {"same": optima}


def gm_unsat_and_timeout(s):
    x = sym(s, "gt_x")
    raised = []
    with pytest.raises(s.exceptions.UnsatError):
        s.model.get_model([x == 1, x == 2])
    raised.append("unsat")
    s.time_handler.start_execution(0)
    try:
        with pytest.raises(s.exceptions.SolverTimeOutException):
            s.model.get_model([x * x == 49])
        raised.append("timeout")
    finally:
        s.time_handler.reset()
    # an UnsatError on a constant-false set, before any solver query
    with pytest.raises(s.exceptions.UnsatError):
        s.model.get_model([s.smt.symbol_factory.BoolVal(False)])
    return {"same": raised + [s.stats().query_count]}


def gm_model_cache_hit(s):
    """A second get_model that the first model satisfies is answered from
    the ModelCache without a solver query; the same set again from the
    result cache."""
    x, y = sym(s, "gc_x"), sym(s, "gc_y")
    first = s.model.get_model([x * y == 35, s.smt.UGT(x, 1)])
    statistics = s.stats()
    queries = statistics.query_count
    again = s.model.get_model([x * y == 35, s.smt.UGT(x, 1),
                               x == first.eval(x)])
    same = s.model.get_model([x * y == 35, s.smt.UGT(x, 1)])
    assert again is first and same is first
    assert statistics.query_count == queries == 1
    zero = s.model.get_model([s.smt.ULT(x, 5)])
    assert zero.eval(x) == 0 and statistics.query_count == 1
    return {"same": [queries, statistics.query_count], "model":
            [first.eval(x), first.eval(y)]}


GET_MODEL_CASES = [gm_optima, gm_unsat_and_timeout, gm_model_cache_hit]


@pytest.mark.parametrize("case", GET_MODEL_CASES, ids=lambda c: c.__name__[3:])
def test_get_model_case(case):
    """support/model.get_model on both packages."""
    assert_parity(case)


# ---- --solver jax waits for ROADMAP A 10 ------------------------------------------------

@pytest.mark.parametrize("entry", ["check_formulas", "check_formulas_oneshot",
                                   "prefetch_formulas", "get_model",
                                   "prefetch_models", "Solver"])
def test_device_lane_raises(entry, monkeypatch):
    """Under `--solver jax` the port refuses the query rather than answer
    on the CDCL in the device lane's place."""
    fresh(PORT)
    x = sym(PORT, "jx")
    raw = [(x * x == 49).raw]
    calls = {
        "check_formulas": lambda: psolver.check_formulas(raw),
        "check_formulas_oneshot": lambda: psolver.check_formulas_oneshot(raw),
        "prefetch_formulas": lambda: psolver.prefetch_formulas([raw]),
        "get_model": lambda: pmodel.get_model([x * x == 49]),
        "prefetch_models": lambda: pmodel.prefetch_models([[x * x == 49]]),
        "Solver": lambda: psmt.Solver().check(x * x == 49)}
    statistics = PORT.stats()
    monkeypatch.setattr(PORT.args, "solver", "jax")
    with pytest.raises(NotImplementedError, match="ROADMAP A 10"):
        calls[entry]()
    assert psolver._pipeline is None
    assert statistics.last_query_clauses == 0
    monkeypatch.setattr(PORT.args, "solver", "cdcl")
    assert calls[entry]() is not None
