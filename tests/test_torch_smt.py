"""The port's own CNF front end (mythril_tpu_torch/smt: terms, smtlib,
simplify, preprocess, bitblast, solver_statistics) against the JAX
package's modules of the same names, on captured analysis queries.

For every 8th query of tests/data/smt2_corpus.tar.gz, `from_smt2` ->
`lower_constraints` -> `Blaster` must give the same clause and variable
counts and the same CDCL verdict in both packages, and the same clause list
wherever the CNF does not depend on the process; every model the port's
native CDCL core finds for the port's CNF must make the port's
`terms.evaluate` hold each lowered constraint true. The verdicts come from
the port's own CDCL (mythril_tpu_torch/native/cdcl.cpp); on each stable
CNF the JAX package's library, solving the JAX clause list, must give the
port's verdict and model bit for bit. The fresh-name counters of both
lowering modules are reset before each query, so a name never depends on
what ran before.

Why "wherever": terms.py orders the operands of a commutative operator by
a hash that includes the ids of their children, so for most captured
queries the clause list depends on object addresses — it differs between
two runs of the JAX package itself, and between the two packages in one
process. STABLE_CNFS lists the queries whose CNF came out the same in four
processes with different hash seeds (`python tests/_torch_sat_constants.py
stability`); those of the sample came out the same in 24 more."""

import itertools
import tarfile

import pytest

from chip_smoke import EXPECTED_SAT, check_model, cnf_digest
from chip_smoke import STABLE_CNFS as STABLE_SMOKE
from mythril_tpu.smt import smtlib as jsmtlib
from mythril_tpu.smt.solver import bitblast as jbitblast
from mythril_tpu.smt.solver import preprocess as jpreprocess
from mythril_tpu.smt.solver import sat as jsat
from mythril_tpu_torch.smt import smtlib, terms
from mythril_tpu_torch.smt.solver import bitblast, preprocess, sat
from mythril_tpu_torch.smt.solver.solver_statistics import SolverStatistics

CORPUS = "tests/data/smt2_corpus.tar.gz"
STRIDE = 8
STABLE_CNFS = frozenset(
    f"{name}.smt2" for name in (
        "1534-1", "1534-3", "1536-1", "1536-2", "1538-1", "1538-10",
        "1538-11", "1538-12", "1538-13", "1538-14", "1538-15", "1538-4",
        "1538-5", "1538-8", "1540-2", "1540-4", "1540-6", "1542-1", "1544-1",
        "1649-1", "1649-3", "1649-5", "1649-6", "1651-1", "1651-2",
        "1672-1", "1672-10", "1672-11", "1672-12", "1672-13", "1672-14",
        "1672-15", "1672-4", "1672-5", "1672-8", "1674-17", "1674-2",
        "1674-21", "1674-4", "1674-6", "1677-1", "1679-1", "1689-10",
        "1689-11", "1689-16", "1689-2", "1689-24", "1689-3", "1689-30",
        "1689-31", "1689-32", "1689-33", "1689-34", "1689-60", "1689-61",
        "1689-62", "1689-63", "1689-64", "1689-8"))


def _corpus(names=None):
    with tarfile.open(CORPUS) as tar:
        members = [m for m in tar.getmembers() if m.name.endswith(".smt2")]
        if names is None:
            members = members[::STRIDE]
        else:
            members = [m for m in members if m.name in names]
        return [(m.name, tar.extractfile(m).read().decode("utf-8"))
                for m in members]


def _blast(smtlib_module, preprocess_module, blaster_cls, text):
    lowered, _ = preprocess_module.lower_constraints(
        list(smtlib_module.from_smt2(text)))
    blaster = blaster_cls()
    for node in lowered:
        blaster.assert_true(node)
    return lowered, blaster


@pytest.fixture
def fresh_names(monkeypatch):
    def reset():
        monkeypatch.setattr(jpreprocess, "_fresh_counter", itertools.count())
        monkeypatch.setattr(preprocess, "_fresh_counter", itertools.count())
    return reset


def test_corpus_cnfs_match_jax(fresh_names):
    queries = _corpus()
    assert len(queries) == 22
    stats = SolverStatistics()
    before = stats.simplify_iterations
    n_sat = n_exact = 0
    for name, text in queries:
        fresh_names()
        _, expected = _blast(jsmtlib, jpreprocess, jbitblast.Blaster, text)
        lowered, got = _blast(smtlib, preprocess, bitblast.Blaster, text)
        assert got.n_vars == expected.n_vars, name
        assert len(got.clauses) == len(expected.clauses), name
        status, model = sat.solve_cnf(got.clauses, got.n_vars, 100_000)
        if name in STABLE_CNFS:
            assert got.clauses == expected.clauses, name
            # the two CDCL libraries, one C++ source, on the same clauses
            assert jsat.solve_cnf_native(expected.clauses, expected.n_vars,
                                         100_000) == (status, model), name
            n_exact += 1
        else:
            assert status == sat.solve_cnf(expected.clauses, expected.n_vars,
                                           100_000)[0], name
        if status == sat.SAT:
            check_model(got.clauses, lowered, got, model, name)
            n_sat += 1
    assert n_sat >= 5 and n_exact >= 8
    assert stats.simplify_iterations > before


def test_chip_constants_cnfs_and_verdicts(fresh_names):
    """chip_smoke.py's CNF digests, sizes and CDCL verdicts, recomputed with
    the JAX package's pipeline and the port's native CDCL core."""
    assert STABLE_SMOKE <= STABLE_CNFS
    for name, text in _corpus(set(EXPECTED_SAT)):
        want = EXPECTED_SAT[name]
        fresh_names()
        _, blaster = _blast(jsmtlib, jpreprocess, jbitblast.Blaster, text)
        assert (len(blaster.clauses), blaster.n_vars) == (want["clauses"],
                                                          want["n_vars"])
        assert ("cnf" in want) == (name in STABLE_SMOKE), name
        if "cnf" in want:
            assert cnf_digest(blaster.clauses, blaster.n_vars) == want["cnf"]
        status, _ = sat.solve_cnf(blaster.clauses, blaster.n_vars, 2_000_000)
        assert status == want["cdcl"], name


def test_evaluate_rejects_a_broken_model(fresh_names):
    """check_model is a real check: flipping a model bit that a clause needs
    is caught."""
    (name, text), = _corpus({"1689-24.smt2"})
    fresh_names()
    lowered, blaster = _blast(smtlib, preprocess, bitblast.Blaster, text)
    status, model = sat.solve_cnf(blaster.clauses, blaster.n_vars, 100_000)
    assert status == sat.SAT
    check_model(blaster.clauses, lowered, blaster, model, name)
    unit = next(c[0] for c in blaster.clauses[1:] if len(c) == 1)
    broken = list(model)
    broken[abs(unit) - 1] = not broken[abs(unit) - 1]
    with pytest.raises(AssertionError):
        check_model(blaster.clauses, lowered, blaster, broken, name)
    assert terms.evaluate(terms.bv_const(5, 8), {}) == 5
