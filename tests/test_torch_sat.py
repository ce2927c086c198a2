"""The port's device SAT lane (mythril_tpu_torch/parallel/device_solver.py)
against the JAX package's (mythril_tpu/parallel/jax_solver.py), on the CPU.

The port runs its plain PyTorch twin (`run_chunk_reference`, what K11
computes); the JAX side runs its jitted runners on the CPU, as
tests/test_jax_solver.py does. Every comparison is exact: the problem
arrays, all five SolverState leaves after each chunk (dtype and shape too),
and the verdicts and models of the entry points."""

import random
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mythril_tpu.parallel  # noqa: F401  (x64 on, as the JAX package runs)
from _torch_parity import assert_same, np_tree
from chip_smoke import three_sat
from mythril_tpu.parallel import jax_solver as js
from mythril_tpu.smt.solver import sat
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import device_solver as ds

CORPUS = "tests/data/smt2_corpus.tar.gz"


def _random_cnf(rng, n_vars, n_clauses, k=3):
    return [[rng.choice([-1, 1]) * rng.randint(1, n_vars)
             for _ in range(rng.randint(1, k))]
            for _ in range(n_clauses)]


def _differential_cnfs():
    """test_jax_solver.py's 30 CNFs around the sat/unsat phase transition."""
    rng = random.Random(7)
    cnfs = []
    for _ in range(30):
        n_vars = rng.randint(3, 24)
        n_clauses = int(n_vars * rng.uniform(2.0, 6.0))
        cnfs.append((_random_cnf(rng, n_vars, n_clauses), n_vars))
    return cnfs


def _jax_state(init_assign, n_probes):
    """The JAX entry points' initial state (a leading query axis if
    `init_assign` has one)."""
    lead = init_assign.shape[:-1] + (n_probes,)
    shape = lead + init_assign.shape[-1:]
    return js._SolverState(
        assign=jnp.asarray(np.broadcast_to(init_assign[..., None, :], shape)),
        trail=jnp.zeros(shape, dtype=jnp.int32),
        tag=jnp.zeros(shape, dtype=jnp.int8),
        trail_len=jnp.zeros(lead, dtype=jnp.int32),
        status=jnp.zeros(lead, dtype=jnp.int8))


def _stack(problems):
    return [np.stack([getattr(p, f) for p in problems])
            for f in ("lits", "valid", "order")]


def _check_model(clauses, model):
    for clause in clauses:
        assert any((model[abs(l) - 1] if l > 0 else not model[abs(l) - 1])
                   for l in clause), f"clause {clause} unsatisfied"


def _run_both(problem, n_probes, chunk, n_chunks, what):
    """JAX `_get_runner` and the port's twin from the same initial state,
    every leaf compared after each chunk; returns the final JAX state."""
    forced_depth = ds.forced_depth_of(n_probes)
    jstate = _jax_state(problem.init_assign, n_probes)
    state = convert.from_numpy("sat_state", np_tree(jstate), "cpu")
    assert_same(jstate, ds.initial_state(problem.init_assign, n_probes, "cpu"),
                f"{what} initial ")
    tensors = convert.from_numpy("sat_problem", problem, "cpu")
    runner = js._get_runner(chunk, forced_depth)
    arrays = [jnp.asarray(a) for a in (problem.lits, problem.valid,
                                       problem.order)]
    for index in range(n_chunks):
        jstate = runner(jstate, *arrays)
        ds.run_chunk(state, tensors, chunk, forced_depth)
        assert_same(jstate, state, f"{what} chunk {index} ")
    return jstate


# ---- the problem arrays ------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["coarse", "fine"])
def test_build_problem_matches_jax(monkeypatch, scheme):
    monkeypatch.setenv("MYTHRIL_TPU_BUCKET_SCHEME", scheme)
    rng = random.Random(11)
    cnfs = _differential_cnfs()[:10] + [
        ([[-1], [-2], [-3], [-4], [1, 2, 3, 4, 5]], 5),
        ([[1, -2, 3, -4, 5, -6, 7], [2, 3], [-7, 1, 4, 6]], 7),
        (_random_cnf(rng, 300, 5000, k=5), 300),
        ([[1, 2], [-1]], 15),
        ([[1]], 1)]
    for clauses, n_vars in cnfs:
        expected = js._build_problem([list(c) for c in clauses], n_vars)
        got = ds.build_problem(clauses, n_vars, scheme=scheme)
        assert got.n_vars == expected.n_vars
        for field in ("lits", "valid", "order", "init_assign"):
            mine, theirs = getattr(got, field), getattr(expected, field)
            assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
            assert np.array_equal(mine, theirs), field
    with pytest.raises(ValueError):
        ds.build_problem([[1]], 1, scheme="medium")


# ---- single-runner states, step for step ---------------------------------------

#: (clauses, n_vars, probes, scheme): a phase-transition CNF; opposite-phase
#: races inside one tile and across two (the higher clause index wins
#: either way); the no-flip backtrack; 32 forced probes; no pad variables
RUNNER_CASES = {
    "race_tile_false": ([[-1, 2], [-1, -2], [3, 4]], 4, 2, "coarse"),
    "race_tile_true": ([[-1, -2], [-1, 2], [3, 4]], 4, 2, "coarse"),
    "race_tiles_false": ([[-1, 2]] * 2100 + [[-1, -2]], 2, 2, "coarse"),
    "race_tiles_true": ([[-1, -2]] * 2100 + [[-1, 2]], 2, 2, "coarse"),
    "no_flip": ([[1, 2], [1, -2], [-1, 3], [-1, -3]], 3, 2, "coarse"),
    "no_flip_single": ([[1, 2], [1, -2], [-1, 3], [-1, -3]], 3, 1, "coarse"),
    "no_pad": (_random_cnf(random.Random(5), 15, 60), 15, 4, "fine"),
}


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_fixture_matches_jax(monkeypatch, case):
    clauses, n_vars, n_probes, scheme = RUNNER_CASES[case]
    monkeypatch.setenv("MYTHRIL_TPU_BUCKET_SCHEME", scheme)
    problem = js._build_problem(clauses, n_vars)
    if case == "no_pad":
        assert problem.order.shape[0] == n_vars + 1
    jstate = _run_both(problem, n_probes, 2, 4, case)
    status = np.asarray(jstate.status)
    if case.startswith("race"):
        # probe 1 decides var 1 true, both clauses turn unit on var 2, and
        # the later clause's phase lands (then the earlier one conflicts)
        assert status.tolist() == [1, 2]
    if case == "no_flip":
        # refuted with every decision forced: the quirk of JAX's no-flip
        # backtrack (trail[0] negated, tag 2, its var keeps its value)
        assert status.tolist() == [2, 2]
        assert np.asarray(jstate.trail)[:, 0].tolist() == [1, -1]
        assert np.asarray(jstate.assign)[:, 1].tolist() == [2, 1]


def test_runner_random_cnfs_match_jax():
    for index, (clauses, n_vars) in enumerate(_differential_cnfs()[:6]):
        problem = js._build_problem(clauses, n_vars)
        _run_both(problem, 8, 8, 3, f"cnf {index}")


def test_runner_forced_prefixes_32_probes():
    """Deep enough for every probe to decide its whole 5-bit cube prefix."""
    problem = js._build_problem(three_sat(9), 60)
    jstate = _run_both(problem, 32, 8, 4, "32 probes")
    exhausted = (np.asarray(jstate.tag) == 2).sum(axis=1)
    assert exhausted.min() >= 3 and exhausted.max() >= 5
    status = np.asarray(jstate.status)
    assert (status == ds.SEARCHING).any() and (status == ds.S_UNSAT).any()


def test_step_is_one_runner_step():
    clauses, n_vars = _differential_cnfs()[3]
    problem = ds.build_problem(clauses, n_vars)
    tensors = ds.device_problem(problem, "cpu")
    plain = ds.initial_state(problem.init_assign, 8, "cpu")
    stepped = convert.clone(plain)
    for _ in range(5):
        plain = ds.step_reference(plain, tensors, 3)
        ds.step(stepped, tensors, 3)
    for mine, theirs in zip(stepped, plain):
        assert torch.equal(mine, theirs)


# ---- the batch runner --------------------------------------------------------------

def test_batch_runner_matches_jax():
    """A bucket of 4 queries, one of which decides in its first steps: the
    freeze keeps it (and only it) still while its siblings step."""
    queries = [(three_sat(9), 60), ([[1, 2], [-1, 2], [-2, 3], [-3]], 3),
               (three_sat(10), 60), (three_sat(11), 60)]
    problems = [js._build_problem(c, n) for c, n in queries]
    assert len({p.lits.shape + p.order.shape for p in problems}) == 1
    n_probes, chunk = 8, 4
    forced_depth = ds.forced_depth_of(n_probes)
    jstate = _jax_state(np.stack([p.init_assign for p in problems]), n_probes)
    state = convert.from_numpy("sat_state", np_tree(jstate), "cpu")
    arrays = _stack(problems)
    tensors = ds.DeviceProblem(*[torch.from_numpy(a) for a in arrays])
    runner = js._get_batch_runner(chunk, forced_depth)
    early = None
    for index in range(5):
        jstate = runner(jstate, *[jnp.asarray(a) for a in arrays])
        ds.run_chunk(state, tensors, chunk, forced_depth, freeze=True)
        assert_same(jstate, state, f"batch chunk {index} ")
        if index == 0:
            early = convert.clone(state)
    status = np.asarray(jstate.status)
    assert (status[1] != 0).all()  # query 1 was decided in the first chunk
    for mine, then in zip(state, early):
        assert torch.equal(mine[1], then[1])
    assert (status[[0, 2, 3]] == 0).any()


# ---- the entry points --------------------------------------------------------------

def test_solve_matches_jax_on_differential_cnfs():
    for index, (clauses, n_vars) in enumerate(_differential_cnfs()):
        expected = js.solve_cnf_device(clauses, n_vars, n_probes=8,
                                       max_steps=50_000, chunk=32)
        got = ds.solve_cnf_device(clauses, n_vars, n_probes=8,
                                  max_steps=50_000, chunk=32, device="cpu")
        assert got == expected, f"cnf {index}"
        assert got[0] == sat.solve_cnf(clauses, n_vars)[0], f"cnf {index}"
        if got[0] == ds.SAT:
            _check_model(clauses, got[1])


def test_solve_batch_matches_jax_on_differential_cnfs():
    queries = _differential_cnfs() + [([], 2), ([[1], []], 1),
                                      ([[1, 2]] * 9, 2)]
    expected = js.solve_cnf_device_batch(queries, n_probes=8, chunk=32,
                                         max_steps=50_000, clause_cap=8)
    got = ds.solve_cnf_device_batch(queries, n_probes=8, chunk=32,
                                    max_steps=50_000, clause_cap=8,
                                    device="cpu")
    assert got == expected
    assert [status for status, _ in got[-3:]] == [ds.SAT, ds.UNSAT,
                                                  ds.UNKNOWN]
    expected = js.solve_cnf_device_batch(queries[:12], n_probes=8, chunk=32)
    got = ds.solve_cnf_device_batch(queries[:12], n_probes=8, chunk=32,
                                    device="cpu")
    assert got == expected


def test_solve_contract_cases():
    """test_jax_solver.py's contract cases, against the port and JAX."""
    def both(clauses, n_vars, **kwargs):
        got = ds.solve_cnf_device(clauses, n_vars, device="cpu", **kwargs)
        assert got == js.solve_cnf_device(clauses, n_vars, **kwargs)
        return got

    status, model = both([[1], [2, -1]], 2, chunk=16)
    assert status == ds.SAT
    _check_model([[1], [2, -1]], model)
    assert both([[1], [-1]], 1, chunk=16)[0] == ds.UNSAT
    assert both([], 3) == (ds.SAT, [False, False, False])
    assert both([[1], []], 1) == (ds.UNSAT, None)
    status, model = both([[-1], [-2], [-3], [-4], [1, 2, 3, 4, 5]], 5,
                         chunk=16)
    assert status == ds.SAT and model[4] is True
    assert both([[-1], [-2], [-3], [-4], [-5], [1, 2, 3, 4, 5]], 5,
                chunk=16)[0] == ds.UNSAT
    # the implication-chain regression (duplicate-index trail scatter)
    clauses = [[1, 2], [1, -2, 3], [-3, -2, 1], [-2, -1], [4, 1, 2]]
    status, model = both(clauses, 4, n_probes=1, chunk=16)
    assert status == ds.SAT
    _check_model(clauses, model)
    assert both([[1, 2], [-1, 2]] * 40, 2, clause_cap=10) == (ds.UNKNOWN,
                                                             None)
    assert ds.solve_cnf_device([[1, 2], [-1, 2]] * 40, 2, clause_cap=10,
                               scheme="fine", device="cpu")[0] == ds.UNKNOWN


# ---- one captured query at full width ------------------------------------------

def _corpus_problem(name):
    """A captured query through the port's from_smt2 -> lower_constraints
    -> Blaster, bucketed by JAX `_build_problem`."""
    from mythril_tpu_torch.smt.smtlib import from_smt2
    from mythril_tpu_torch.smt.solver.bitblast import Blaster
    from mythril_tpu_torch.smt.solver.preprocess import lower_constraints

    with tarfile.open(CORPUS) as tar:
        text = tar.extractfile(name).read().decode("utf-8")
    lowered, _ = lower_constraints(list(from_smt2(text)))
    blaster = Blaster()
    for node in lowered:
        blaster.assert_true(node)
    return js._build_problem(blaster.clauses, blaster.n_vars)


def test_full_width_corpus_query_matches_jax():
    """1689-24 (57,463 clauses over 16,468 vars) at the lane's full width:
    64 tiles, V1 = 65,536, 32 probes, 32 steps of JAX `_get_runner`
    against the twin, every leaf bit-identical."""
    problem = _corpus_problem("1689-24.smt2")
    assert problem.lits.shape == (64, ds.TILE, 3)
    assert problem.order.shape == (1 << 16,)
    jstate = _run_both(problem, 32, 32, 1, "1689-24")
    assert int(np.asarray(jstate.trail_len).min()) > 5


def test_full_width_256_tile_query_matches_jax():
    """1689-28 (143,559 clauses) in the 256-tile bucket: the port's own CNF
    of it (which CNF does not matter here), 32 probes, 16 steps of JAX
    `_get_runner` against the twin, every leaf bit-identical."""
    problem = _corpus_problem("1689-28.smt2")
    assert problem.lits.shape == (256, ds.TILE, 3)
    assert problem.order.shape == (1 << 16,)
    jstate = _run_both(problem, 32, 16, 1, "1689-28")
    assert int(np.asarray(jstate.trail_len).min()) > 5
