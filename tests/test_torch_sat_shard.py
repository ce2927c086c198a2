"""The port's clause-sharded SAT route (K13: `device_solver.configure`,
`run_chunk_sharded`, `kernels/sat_step.cu`'s sharded entries) against the
JAX package's `_get_sharded_runner`, on the conftest's 8-device CPU mesh.

The port's mesh is `configure(shard=True, mesh=("cpu",) * 8)`, the JAX
side's MYTHRIL_TPU_SHARD=1 over its 8 virtual devices. Every comparison
is exact: all five SolverState leaves after each chunk, the verdicts,
models and shape keys of `solve_cnf_device`, and `warm_shape_key`'s
answers. The sharded entries of sat_step.cu, compiled by g++ against
`_host_shim.h`, are held to the twin."""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mythril_tpu.parallel  # noqa: F401  (x64 on, as the JAX package runs)
from _torch_parity import assert_same
from _torch_sat_constants import jax_cnf
from chip_smoke import race_cnf
from mythril_tpu.parallel import jax_solver as js
from mythril_tpu.smt.solver import preprocess as jpreprocess
from mythril_tpu.support import tpu_config
from mythril_tpu_torch.kernels import build, ops
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import device_solver as ds
from mythril_tpu_torch.smt.solver import sat
from test_torch_sat import _jax_state

CPU8 = ("cpu",) * 8
SHIM = os.path.join(os.path.dirname(__file__), "_host_shim.h")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Each case from fresh shape-key sets on both sides, the port's lane
    settings back to their defaults after it, and one torch thread (the
    twin is many small ops)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8-device CPU mesh")
    monkeypatch.setattr(js, "_SHAPES_RUN", set())
    monkeypatch.setattr(ds, "_SHAPES_RUN", set())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    ds.reset_settings()


def race_last_cnf():
    """The deciding units in the last shard's last propagate block: var 5
    TRUE in shard 0 and FALSE at the very last clause; var 6 FALSE in shard
    2 of 4 and TRUE at the last clause but one (unsharded: TRUE)."""
    clauses = [[5]] + [[1, 2, 3]] * 4999 + [[-6]] + [[1, 2, 4]] * 3189
    return clauses + [[6], [-5]], 8


def planted_cnf(seed: int, n_tiles: int = 8, n_vars: int = 400):
    """A planted-solution 3-SAT over `n_tiles` full tiles (test_jax_solver's
    sharded case): every clause agrees with the planted assignment."""
    rng = np.random.default_rng(seed)
    planted = rng.integers(0, 2, size=n_vars).astype(bool)
    clauses = []
    for _ in range((n_tiles - 1) * ds.TILE + 5):
        variables = rng.choice(n_vars, size=3, replace=False) + 1
        signs = rng.integers(0, 2, size=3) * 2 - 1
        clause = [int(v * s) for v, s in zip(variables, signs)]
        if not any((lit > 0) == planted[abs(lit) - 1] for lit in clause):
            lit = clause[0]
            clause[0] = abs(lit) if planted[abs(lit) - 1] else -abs(lit)
        clauses.append(clause)
    return clauses, n_vars


def _run_sharded_both(clauses, n_vars, n_probes, n_shards, chunk, n_chunks,
                      what):
    """JAX `_get_sharded_runner` and the port's twin from the same initial
    state, every leaf compared after each chunk; returns the twin's state
    and problem."""
    problem = ds.build_problem(clauses, n_vars)
    depth = ds.forced_depth_of(n_probes)
    jstate = _jax_state(problem.init_assign, n_probes)
    state = ds.initial_state(problem.init_assign, n_probes, "cpu")
    tensors = ds.device_problem(problem, "cpu")
    runner, _ = js._get_sharded_runner(chunk, depth, n_shards)
    arrays = [jnp.asarray(a) for a in (problem.lits, problem.valid,
                                       problem.order)]
    for index in range(n_chunks):
        jstate = runner(jstate, *arrays)
        ds.run_chunk_sharded(state, tensors, chunk, depth,
                             (torch.device("cpu"),) * n_shards)
        assert_same(jstate, state, f"{what} D={n_shards} chunk {index} ")
    return state, tensors


# ---- the twin against JAX `_get_sharded_runner` -------------------------------

@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_race_twin_matches_sharded_runner(n_shards):
    """The phase race at D = 2, 4, 8 (4 tiles: D = 8 takes the coarse
    bucket's 16), forced depth 1, one step and then a few more."""
    clauses, n_vars = race_cnf()
    if n_shards == 8:
        clauses = clauses + [[1, 2, 3]] * (4 * ds.TILE + 1)
    state, tensors = _run_sharded_both(clauses, n_vars, 2, n_shards, 1, 3,
                                       "race")
    unsharded = ds.initial_state(ds.build_problem(clauses, n_vars)
                                 .init_assign, 2, "cpu")
    ds.run_chunk_reference(unsharded, tensors, 1, 1)
    assert unsharded.assign[:, 5].tolist() == [1, 1]
    if n_shards == 4:
        fresh = ds.initial_state(ds.build_problem(clauses, n_vars)
                                 .init_assign, 2, "cpu")
        ds.run_chunk_sharded_reference(fresh, tensors, 1, 1, 4)
        assert fresh.assign[:, 5].tolist() == [2, 2]


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_planted_twin_matches_sharded_runner(n_shards):
    """A planted 3-SAT over 8 tiles (the coarse bucket's 16) at 4 probes,
    three chunks of 4 steps (the batch case's runner at D = 4)."""
    clauses, n_vars = planted_cnf(7)
    state, _ = _run_sharded_both(clauses, n_vars, 4, n_shards, 4, 3,
                                 "planted")
    assert int(state.trail_len.min()) > 5


def test_batch_shaped_twin_matches_sharded_runner_per_query():
    """A batch-shaped state (two queries of one bucket, the second decided
    in its first steps and frozen by its status) steps each query as the
    JAX sharded runner steps it alone."""
    cnfs = [race_last_cnf(),
            ([[1, 2], [-1, 2], [-2, 3], [-3]] + [[4, 5]] * 5000, 5)]
    problems = [ds.build_problem(c, n) for c, n in cnfs]
    state = ds.initial_state(np.stack([p.init_assign for p in problems]), 4,
                             "cpu")
    tensors = ds.device_problem(problems, "cpu")
    runner, _ = js._get_sharded_runner(4, 2, 4)
    jstates = [_jax_state(p.init_assign, 4) for p in problems]
    for index in range(3):
        ds.run_chunk_sharded_reference(state, tensors, 4, 2, 4)
        for query, problem in enumerate(problems):
            jstates[query] = runner(jstates[query], jnp.asarray(problem.lits),
                                    jnp.asarray(problem.valid),
                                    jnp.asarray(problem.order))
            assert_same(jstates[query],
                        ds.SolverState(*[leaf[query] for leaf in state]),
                        f"query {query} chunk {index} ")
    assert (state.status[1] == ds.S_UNSAT).all()


# ---- the mesh settings and the entry points --------------------------------------

def test_settings_follow_the_jax_knob(monkeypatch):
    """configure's defaults are MYTHRIL_TPU_SHARD's (unset: shard only a
    mesh of cards) and its three values pick JAX's device count."""
    knob = tpu_config.REGISTRY["MYTHRIL_TPU_SHARD"]
    assert knob.default is None and ds._DEFAULT_SETTINGS["shard"] is None
    assert ds._DEFAULT_SETTINGS["mesh"] is None
    cpu = ds.mesh_devices("cpu")
    assert cpu == (torch.device("cpu"),) and ds.shard_count(cpu) == 1
    clauses, n_vars = planted_cnf(3, n_tiles=2)
    for flag, shard in ((None, None), ("1", True), ("0", False)):
        if flag is None:
            monkeypatch.delenv("MYTHRIL_TPU_SHARD", raising=False)
        else:
            monkeypatch.setenv("MYTHRIL_TPU_SHARD", flag)
        ds.configure(shard=shard, mesh=CPU8)
        js._SHAPES_RUN.clear()
        ds._SHAPES_RUN.clear()
        expected = js.solve_cnf_device(clauses, n_vars, n_probes=4, chunk=8,
                                       max_steps=8)
        got = ds.solve_cnf_device(clauses, n_vars, n_probes=4, chunk=8,
                                  max_steps=8, device="cpu")
        assert got == expected
        assert ds.observed_shape_keys() == js.observed_shape_keys()
        want = 8 if shard else 1
        assert ds.shard_count(ds.mesh_devices("cpu")) == want
        assert ds.observed_shape_keys()[0][1] == want


@pytest.fixture
def one_card(monkeypatch):
    """torch as on a host with one card (nothing is placed on it: every
    case below is refused before a tensor is made)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("mesh, device", [
    (("cuda:0", "cuda:1"), None),     # cuda:1 is not there
    (CPU8, None),                     # a CPU mesh under a card call
    (("cuda:0",) * 2, "cpu")])        # a card mesh under a CPU call
def test_missing_mesh_device_raises(one_card, mesh, device):
    """A mesh device that is not there, or a mesh on another device type
    than the call's, raises DeviceUnavailable (from solve_cnf_device and
    from warm_shape_key): the call never moves to another kind of device."""
    from mythril_tpu_torch.exceptions import DeviceUnavailable

    ds.configure(shard=True, mesh=mesh)
    with pytest.raises(DeviceUnavailable):
        ds.solve_cnf_device([[1, 2]], 2, device=device)
    with pytest.raises(DeviceUnavailable):
        ds.warm_shape_key(("single", 2, 1, 1, 2, 1024, 2), device=device)
    assert ds.observed_shape_keys() == []


def _both_sharded(monkeypatch, clauses, n_vars, **kwargs):
    monkeypatch.setenv("MYTHRIL_TPU_SHARD", "1")
    ds.configure(shard=True, mesh=CPU8)
    expected = js.solve_cnf_device(clauses, n_vars, **kwargs)
    got = ds.solve_cnf_device(clauses, n_vars, device="cpu", **kwargs)
    assert got == expected
    assert ds.observed_shape_keys() == js.observed_shape_keys()
    return got


def test_solve_matches_jax_sharded(monkeypatch):
    """Statuses, models and shape keys of both packages' solve_cnf_device
    over 8 shards: the planted 3-SAT and an UNSAT pin on it (16 tiles:
    sharded), small CNFs whose one tile does not divide (unsharded, keyed
    with 8 devices), and the cap: above it unsharded, above 8 times it
    always."""
    clauses, n_vars = planted_cnf(7)
    status, model = _both_sharded(monkeypatch, clauses, n_vars, n_probes=8,
                                  chunk=64, max_steps=4096)
    assert status == ds.SAT
    for clause in clauses:
        assert any((lit > 0) == model[abs(lit) - 1] for lit in clause)
    pinned = clauses + [[n_vars + 1], [-(n_vars + 1)]]
    assert _both_sharded(monkeypatch, pinned, n_vars + 1, n_probes=8,
                         chunk=64, max_steps=4096)[0] == ds.UNSAT
    assert _both_sharded(monkeypatch, [[1], [2, -1]], 2, chunk=16)[0] \
        == ds.SAT
    assert _both_sharded(monkeypatch, [[1, 2], [-1, 2]] * 40, 2,
                         clause_cap=10) == (ds.UNKNOWN, None)
    assert _both_sharded(monkeypatch, clauses, n_vars, n_probes=8, chunk=64,
                         max_steps=64, clause_cap=len(clauses) // 9) \
        == (ds.UNKNOWN, None)
    keys = ds.observed_shape_keys()
    assert ("single", 8, 64, 3, 16, 1024, 8) in keys
    assert ("single", 8, 16, 5, 1, 1024, 32) in keys


def test_corpus_query_between_the_cap_and_eight_times_it(monkeypatch):
    """1672-3 (66,436 clauses, 64 tiles) with the cap at an eighth of its
    clauses, rounded up: the unsharded lane answers UNKNOWN, both packages
    over 8 shards decide it, with the same verdict and shape keys. The
    CDCL core agrees (UNSAT). It is the captured query of the 64-tile
    bucket that the lane decides in the fewest steps (two, at one probe);
    1689-24 takes 3,672 there, minutes of both packages on the CPU, and is
    decided sharded on the card by chip_smoke.py's sat_shard phase."""
    # jax_cnf numbers fresh names from 0, as a fresh process would; the
    # JAX pipeline's counter is a process global that later files on this
    # worker go on from, so it is put back after the case
    monkeypatch.setattr(jpreprocess, "_fresh_counter",
                        jpreprocess._fresh_counter)
    clauses, n_vars = jax_cnf("1672-3.smt2")
    cap = -(-len(clauses) // 8)
    assert cap < len(clauses) <= 8 * cap
    assert ds.solve_cnf_device(clauses, n_vars, clause_cap=cap,
                               device="cpu") == (ds.UNKNOWN, None)
    assert _both_sharded(monkeypatch, clauses, n_vars, n_probes=1, chunk=16,
                         clause_cap=cap) == (ds.UNSAT, None)
    assert sat.solve_cnf(clauses, n_vars)[0] == sat.UNSAT
    assert ds.observed_shape_keys() == [("single", 8, 16, 0, 64, 1 << 16,
                                         1)]


@pytest.mark.parametrize("key", [
    ("single", 8, 2, 1, 8, 1024, 2), ("single", 8, 1, 1, 16, 1024, 4),
    ("single", 16, 2, 1, 16, 1024, 2), ("single", 8, 2, 1, 4, 1024, 2),
    ("single", 2, 2, 1, 3, 1024, 2), ("single", 4, 1, 2, 4, 1024, 4)])
def test_warm_shape_key_matches_jax(monkeypatch, key):
    """Multi-device keys: warmed where the 8-device mesh hosts them and the
    tiles divide, refused otherwise, as JAX's; a warmed key is then
    observed on both sides."""
    ds.configure(shard=True, mesh=CPU8)
    expected = js.warm_shape_key(key)
    assert ds.warm_shape_key(key, device="cpu") is expected
    assert ds.observed_shape_keys() == js.observed_shape_keys()
    assert expected == (key[1] <= 8 and key[4] % key[1] == 0)


# ---- the sharded entries of sat_step.cu under the host shim -------------------------

@pytest.fixture(scope="module")
def host_sat(tmp_path_factory):
    """sat_step.cu built by g++ against the host shim."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source with")
    lib = str(tmp_path_factory.mktemp("host_sat") / "libsat_step.so")
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wall",
         "-Werror", "-include", SHIM, "-x", "c++",
         os.path.join(build.KERNEL_DIR, "sat_step.cu"), "-o", lib],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(lib)


@pytest.fixture
def on_host(host_sat, monkeypatch):
    """Route the wrappers to the host-built kernels and CPU tensors."""

    def check(t, what, dtype, shape=None):
        assert t.dtype == dtype, what
        assert shape is None or tuple(t.shape) == tuple(shape), what
        assert t.is_contiguous(), what
        return t.data_ptr()

    monkeypatch.setattr(build, "load", lambda name: host_sat)
    monkeypatch.setattr(ops, "_FUNCS", {})
    monkeypatch.setattr(ops, "_check", check)
    monkeypatch.setattr(ops, "_raw_stream", lambda: 0)
    monkeypatch.setattr(ops, "_SAT_SHARD_PLANS", ops._Plans(limit=2))


SHIM_CASES = {"race": (race_cnf, 2, (2, 4), 1, 3),
              "race_last": (race_last_cnf, 2, (2, 4), 1, 3),
              "planted": (lambda: planted_cnf(5), 4, (8,), 3, 2)}


@pytest.mark.parametrize("case", sorted(SHIM_CASES))
def test_host_sharded_chunk_matches_twin(on_host, case):
    """K13 (every shard's propagate into its plane, the planes' copies,
    the combine, count and apply) against the twin: every leaf after each
    chunk from one plan, each shard's replica equal to the state, and the
    combine's launch counted a chunk. `race_last` puts the deciding
    shard's units in the last propagate block of the last shard."""
    make, n_probes, shard_counts, chunk, n_chunks = SHIM_CASES[case]
    clauses, n_vars = make()
    problem = ds.build_problem(clauses, n_vars)
    tensors = ds.device_problem(problem, "cpu")
    depth = ds.forced_depth_of(n_probes)
    for n_shards in shard_counts:
        mesh = (torch.device("cpu"),) * n_shards
        plain = ds.initial_state(problem.init_assign, n_probes, "cpu")
        kernel = convert.clone(plain)
        ops.reset_launches()
        for index in range(n_chunks):
            ds.run_chunk_sharded_reference(plain, tensors, chunk, depth,
                                           n_shards)
            ops.sat_run_sharded(kernel, tensors, chunk, depth, mesh,
                                var_tile=64)
            for name, got, ref in zip(ds.SolverState._fields, kernel,
                                      plain):
                assert torch.equal(got, ref), \
                    f"{case} D={n_shards} chunk {index}: {name}"

            for replica in ops.sat_shard_replicas(kernel, tensors, depth,
                                                  mesh, var_tile=64):
                assert all(torch.equal(a, b)
                           for a, b in zip(replica, kernel))
            if case == "race_last" and n_shards == 4 and index == 0:
                # shard 2's FALSE beats the last clause's TRUE
                assert kernel.assign[:, 6].tolist() == [2, 2]
        assert ops.LAUNCHES["sat_shard_combine"] == n_chunks
        assert ops.LAUNCHES["sat_step"] == n_chunks


def _bitmap_words(bits: torch.Tensor) -> torch.Tensor:
    """int32 [..., ceil(V1 / 32)] words of a bool [..., V1] (var v at bit
    v % 32 of word v // 32), as the kernels' bitmaps lay them out."""
    v1 = bits.shape[-1]
    padded = torch.zeros(bits.shape[:-1] + (-(-v1 // 32) * 32,),
                         dtype=torch.int64)
    padded[..., :v1] = bits.long()
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64)
    words = (padded.view(bits.shape[:-1] + (-1, 32)) * weights).sum(-1)
    return torch.from_numpy(words.numpy().astype(np.uint32).view(np.int32))


def sealed_planes(state, tensors, n_shards) -> torch.Tensor:
    """int32 [D, N_XCHG]: what each shard's seal writes after a propagate
    of `state`, derived from the twin: the keyed-var and FALSE-phase
    bitmaps of `_shard_keys`' [Q, P, D, V1] keys, and the conflict and
    unit flags of the shard's clauses, for the searching probes."""
    batched, lits, valid, _ = ds._batched(state, tensors)
    n_queries, n_probes, v1 = batched.assign.shape
    n_clauses = lits.shape[1]
    conflict, key, unit_var = ds._clause_units(batched.assign, lits, valid)
    shard = torch.arange(n_clauses) // (n_clauses // n_shards)
    keys = ds._shard_keys(key, unit_var, v1, shard, n_shards)
    searching = (batched.status == ds.SEARCHING)[..., None]
    keyed = (keys != 0) & searching[..., None]
    by_shard = (n_queries, n_probes, n_shards, n_clauses // n_shards)
    flags = [(conflict & searching).view(by_shard).any(-1),
             ((key != 0) & searching).view(by_shard).any(-1)]
    planes = []
    for d in range(n_shards):
        planes.append(torch.cat(
            [_bitmap_words(keyed[:, :, d]).flatten(),
             _bitmap_words(keyed[:, :, d] & (keys[:, :, d] & 1 == 0))
             .flatten()]
            + [flag[:, :, d].flatten().to(torch.int32) for flag in flags]))
    return torch.stack(planes)


def _padded_to(clauses, n_vars, n_shards):
    """`clauses` with satisfied padding until the tiles divide over D."""
    while ds.build_problem(clauses, n_vars).lits.shape[0] % n_shards:
        clauses = clauses + [[1, 2, 3]] * (4 * ds.TILE + 1)
    return clauses


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(SHIM_CASES))
def test_host_sealed_planes_are_the_twins_keys(on_host, case, n_shards):
    """After each K13 step (as many as the case's chunks hold) every slot
    of every shard's exchange planes holds the sealing shard's plane (two
    bitmaps a probe and two flags), and that plane is the twin's: the vars
    the shard's clauses key and those whose highest such clause implies
    FALSE, from `_shard_keys` on the state before the step. The step's
    result is the twin's too, and some step keys a var."""
    make, n_probes, _, chunk, n_chunks = SHIM_CASES[case]
    clauses, n_vars = make()
    clauses = _padded_to(clauses, n_vars, n_shards)
    problem = ds.build_problem(clauses, n_vars)
    tensors = ds.device_problem(problem, "cpu")
    depth = ds.forced_depth_of(n_probes)
    mesh = (torch.device("cpu"),) * n_shards
    state = ds.initial_state(problem.init_assign, n_probes, "cpu")
    kernel = convert.clone(state)
    keyed = 0
    for step in range(chunk * n_chunks):
        want = sealed_planes(state, tensors, n_shards)
        keyed += int(want[:, :-2 * n_probes].any())
        ops.sat_run_sharded(kernel, tensors, 1, depth, mesh, var_tile=64)
        for index, planes in enumerate(ops.sat_shard_planes(
                kernel, tensors, depth, mesh, var_tile=64)):
            assert torch.equal(planes, want), \
                f"{case} D={n_shards} step {step} shard {index}"
        ds.run_chunk_sharded_reference(state, tensors, 1, depth, n_shards)
        assert all(torch.equal(a, b) for a, b in zip(kernel, state))
    assert keyed, f"{case} D={n_shards}: no step keyed a var"
