"""The port's solver stack on captured analysis queries
(tests/data/smt2_corpus.tar.gz), against the JAX package's: the
differential replay of tests/test_solver_corpus.py::test_oneshot_vs_incremental
on the sample tests/test_torch_smt.py uses, and the get_model optimum that
chip_smoke.py's host_solver phase holds the port to."""

import pytest

from chip_smoke import (EXPECTED_SAT, HOST_SOLVER_OBJECTIVE, HOST_SOLVER_OPTIMUM,
                        HOST_SOLVER_QUERY, corpus_text)
from mythril_tpu.smt import smtlib as jsmtlib
from mythril_tpu.smt.solver import incremental as jincremental
from mythril_tpu_torch import smt
from mythril_tpu_torch.smt import smtlib
from mythril_tpu_torch.smt.solver import incremental, simplify
from mythril_tpu_torch.smt.solver import solver as solver_module
from mythril_tpu_torch.support import model as model_service
import _torch_sat_constants
from test_torch_smt import _corpus

BUDGET = 100_000


@pytest.fixture(autouse=True)
def _fresh_backend():
    """Each test from a fresh solver backend, and none leaves its simplify
    memo behind: tests/test_torch_smt.py, which a test worker may run next
    in this process, counts the simplifier's iterations on the same
    queries."""
    solver_module.reset_solver_backend()
    simplify.reset_simplify_memo()
    yield
    solver_module.reset_solver_backend()
    simplify.reset_simplify_memo()


def test_oneshot_vs_incremental():
    """On every sampled query the port's one-shot route
    (`check_formulas_oneshot`), the port's incremental pipeline and the JAX
    package's incremental pipeline agree wherever they decide, and every SAT
    model makes each parsed constraint true. (Models are held equal where
    the CNF is the same: tests/test_torch_smt.py solves each STABLE_CNFS
    query's clause list with both CDCL libraries.)"""
    queries = _corpus()
    port = incremental.IncrementalPipeline()
    jax = jincremental.IncrementalPipeline()
    decided = 0
    try:
        for name, text in queries:
            constraints = smtlib.from_smt2(text)
            jconstraints = jsmtlib.from_smt2(text)
            oneshot, oneshot_model = solver_module.check_formulas_oneshot(
                constraints, BUDGET)
            verdict, model = port.check(constraints, BUDGET)
            jverdict, jmodel = jax.check(jconstraints, BUDGET)
            known = {v for v in (oneshot, verdict, jverdict) if v != "unknown"}
            assert len(known) <= 1, (name, oneshot, verdict, jverdict)
            for status, found, cons in ((oneshot, oneshot_model, constraints),
                                        (verdict, model, constraints),
                                        (jverdict, jmodel, jconstraints)):
                if status == "sat":
                    assert all(found.eval(c) is True for c in cons), name
            decided += "unknown" not in (oneshot, verdict, jverdict)
    finally:
        port.close()
        jax.close()
    assert decided >= len(queries) * 0.7, f"{decided}/{len(queries)} decided"


def test_chip_smoke_get_model_optimum_is_the_jax_one():
    """chip_smoke.py's host_solver phase minimizes 1540-2's gas with the
    port's get_model and holds it to HOST_SOLVER_OPTIMUM: recompute that
    with the JAX package's get_model, then with the port's."""
    assert HOST_SOLVER_QUERY in EXPECTED_SAT
    assert _torch_sat_constants.get_model_optimum() == HOST_SOLVER_OPTIMUM
    constraints = [smt.Bool(raw) for raw in
                   smtlib.from_smt2(corpus_text(HOST_SOLVER_QUERY))]
    gas = smt.symbol_factory.BitVecSym(*HOST_SOLVER_OBJECTIVE)
    best = model_service.get_model(constraints, minimize=(gas,))
    assert best.eval(gas) == HOST_SOLVER_OPTIMUM
    assert all(best.eval(c) is True for c in constraints)


@pytest.mark.parametrize("name", sorted(EXPECTED_SAT))
def test_chip_smoke_facade_verdicts(name):
    """host_solver's `Solver().check()` on each EXPECTED_SAT query gives the
    CDCL verdict chip_smoke.py holds it to."""
    constraints = [smt.Bool(raw) for raw in smtlib.from_smt2(corpus_text(name))]
    solver = smt.Solver()
    solver.add(*constraints)
    status = solver.check()
    assert {"sat": 1, "unsat": 0}[status] == EXPECTED_SAT[name]["cdcl"]
    if status == "sat":
        assert all(solver.model().eval(c) is True for c in constraints)
