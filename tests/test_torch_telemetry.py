"""The port's telemetry plane (mythril_tpu_torch.parallel.symstep) against
the JAX package's, exactly.

`run_chunk` with the plane armed (tag pcs and fleet slots) on
test_frontier_telemetry.py's straight line, the planes contract, KILLBILLY
(its SLOAD pauses on a symbolic storage base), a branchy body (forks,
pushes and spills at small pools) and a lane that errors on a stack
underflow: every leaf, every counter of the plane included, equals JAX
after every chunk. A second run with a small arena kills lanes on
overflow. The summary with the telemetry words at its end equals JAX
`_summary`, and a scheduler without the plane carries none."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_same, np_tree, seed_frontier, to_port
from chip_smoke import PLANES_SOURCE, branchy_contract
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import frontier as tf
from mythril_tpu_torch.parallel import symstep as tsym
from test_analysis import KILLBILLY
from test_frontier_telemetry import STRAIGHT_LINE

N_LANES = 8
CHUNK = 12
N_CHUNKS = 6
CODES = [STRAIGHT_LINE,
         assemble(dispatcher({"planes()": PLANES_SOURCE})),
         assemble(dispatcher(KILLBILLY)),
         assemble(dispatcher({"stress()": branchy_contract(4)})),
         bytes.fromhex("01")]  # ADD on an empty stack: ERRORED
#: straight-line pcs, dispatcher entry pcs, and one pc no lane reaches
TAG_PCS = [2, 5, 13, 0x1B, 0x40, 0x7FF]
#: seeding context -> fleet slot (contexts 0..4; -1 lanes clamp to 0)
FLEET_SLOTS = [0, 1, 1, 2, 0]


def test_tables_match_jax():
    assert tsym.OP_CLASS_NAMES == jsym.OP_CLASS_NAMES
    assert tsym.LIFECYCLE_NAMES == jsym.LIFECYCLE_NAMES
    assert tsym.ESC_CAUSE_NAMES == jsym.ESC_CAUSE_NAMES
    assert tsym.TELEMETRY_FIXED_WORDS == jsym.TELEMETRY_FIXED_WORDS
    assert np.array_equal(tsym.OP_CLASS, np.asarray(jsym.OP_CLASS))
    ref = np_tree(jsym.new_telemetry(TAG_PCS, FLEET_SLOTS, 3))
    assert_same(ref, tsym.new_telemetry(TAG_PCS, FLEET_SLOTS, 3,
                                        device="cpu"))


def _armed_run(arena_capacity=1 << 12):
    """(jax, port) trees after every chunk of run_chunk with the plane
    armed, the escape count zeroed between chunks as a drain does."""
    state, planes, arena = seed_frontier(CODES, N_LANES, base_sym=[2],
                                         arena_capacity=arena_capacity)
    telemetry = jsym.new_telemetry(TAG_PCS, FLEET_SLOTS, 3)
    sched = jsym.new_scheduler(state, planes, 4, 3, telemetry=telemetry)
    port = [to_port(kind, tree) for kind, tree in
            zip(("state", "planes", "arena", "sched"),
                (state, planes, arena, sched))]
    trace = []
    for _ in range(N_CHUNKS):
        state, planes, arena, sched = jsym.run_chunk(state, planes, arena,
                                                     sched, CHUNK)
        port = list(tsym.run_chunk(*port, CHUNK))
        trace.append((np_tree((state, planes, arena, sched)),
                      tuple(convert.clone(t) for t in port)))
        sched = sched._replace(esc_count=jnp.zeros_like(sched.esc_count))
        port[3].esc_count.zero_()
    return trace


@pytest.fixture(scope="module")
def armed():
    return _armed_run()


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
@pytest.mark.parametrize("kind", ["state", "planes", "arena", "sched"])
def test_armed_run_chunk_matches_jax(armed, chunk, kind):
    index = ["state", "planes", "arena", "sched"].index(kind)
    jax_tree, port_tree = armed[chunk][0][index], armed[chunk][1][index]
    assert_same(jax_tree, port_tree, f"chunk {chunk} {kind}.")


def test_armed_run_exercises_the_counters(armed):
    """The comparison is worth something only if the counters moved:
    every opcode class the contracts use, escapes of several causes, a
    paused cold SLOAD, an ERRORED death, forks claimed, pushed and
    spilled, tag and fleet occupancy."""
    tel = armed[-1][0][3].telemetry
    lc = dict(zip(jsym.LIFECYCLE_NAMES, tel.lifecycle))
    causes = dict(zip(jsym.ESC_CAUSE_NAMES, tel.esc_cause))
    for name in ("reseeds", "err_deaths", "esc_buffered", "cold_sloads",
                 "forks_claimed", "forks_pushed", "forks_spilled"):
        assert lc[name] > 0, name
    assert causes["halt"] > 0 and causes["host_op"] + causes[
        "sym_mem_region"] + causes["dirty_mload"] > 0
    assert np.count_nonzero(tel.op_hist) >= 8
    assert tel.tag_occ[0] > 0 and tel.tag_occ[-1] == 0
    assert np.count_nonzero(tel.fleet_occ) == 3
    assert tel.occupancy[1] == N_CHUNKS * CHUNK and tel.hwm[0] > 0


def test_arena_overflow_kills_are_counted():
    """A 64-node arena runs out mid-run: the lanes it kills, and the
    frozen escapes and fork waits that follow, are counted as JAX counts
    them."""
    trace = _armed_run(arena_capacity=64)
    jax_trees, port_trees = trace[-1]
    for kind, jax_tree, port_tree in zip(("state", "planes", "arena",
                                          "sched"), jax_trees, port_trees):
        assert_same(jax_tree, port_tree, f"{kind}.")
    lc = dict(zip(jsym.LIFECYCLE_NAMES, jax_trees[3].telemetry.lifecycle))
    for name in ("overflow_kills", "esc_frozen", "fork_waits",
                 "frozen_revived"):
        assert lc[name] > 0, name


def test_summary_carries_the_telemetry_words(armed):
    jax_trees, port_trees = armed[2]
    ref = np.asarray(jf._summary(*jax_trees))
    got = tf.summary_reference(*port_trees).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    n = N_LANES
    tail = got[tf.SUMMARY_SCALARS + 3 * n:]
    assert np.array_equal(tail, tsym.telemetry_words(
        port_trees[3].telemetry).numpy())
    assert len(tail) == tsym.TELEMETRY_FIXED_WORDS + len(TAG_PCS) + 3


def test_off_scheduler_carries_no_plane():
    state, planes, arena = seed_frontier(CODES[:1], N_LANES)
    p_state, p_planes = to_port("state", state), to_port("planes", planes)
    sched = tsym.new_scheduler(p_state, p_planes, 4, 3)
    assert sched.telemetry is None
    _, _, _, sched = tsym.run_chunk(p_state, p_planes,
                                    to_port("arena", arena), sched, CHUNK)
    assert sched.telemetry is None
    summary = tf.summary_reference(p_state, p_planes, to_port("arena", arena),
                                   sched)
    assert summary.shape[0] == tf.SUMMARY_SCALARS + 3 * N_LANES
