"""The port's frontier drain loop (mythril_tpu_torch.parallel.frontier)
against the JAX package's `_Frontier`, exactly.

Programs: the twins of `_summary`, `_row_maxima`, `_pack_rows` (with the
host's `_drain_unpack`), `_reset_esc`, `_gather_rows` and `_scatter_rows`
on a real mid-run state: 16 lanes of `dispatcher(branchy(9))` and the
planes contract, two chunks in, with escape rows buffered.

Driver: `DeviceFrontier(16, device="cpu").run` against JAX
`_Frontier(laser_evm=None, n_lanes=16).run` with telemetry and state
merging off and 32-row pools, until the tree drains: every deferred row
block, every counter and the mirrored arena columns are equal, and the
frozen-lane deferral, the deadlock spill and the host reseed each ran.
(branchy(8) never deadlocks at these pools; branchy(9) does.) Neither
contract has a symbolic storage base, so no lane pauses on a cold SLOAD."""

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, np_tree, seed_frontier, to_port
from chip_smoke import PLANES_SOURCE, branchy_contract
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import batch as jb
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import arena as ta
from mythril_tpu_torch.parallel import batch as tb
from mythril_tpu_torch.parallel import frontier as tf
from test_analysis import KILLBILLY

N_LANES = 16
POOL_ROWS = 32
MAX_CONDS = 16
CODES = [assemble(dispatcher({"stress()": branchy_contract(9)})),
         assemble(dispatcher({"planes()": PLANES_SOURCE}))]


@pytest.fixture(scope="module", autouse=True)
def _unspent_time_budget():
    """The JAX driver stops at the host engine's global time budget, which
    an analysis test run earlier in this process may have left spent: run
    these tests with it disarmed, as a fresh process has it."""
    from mythril_tpu.core.time_handler import time_handler

    saved = (time_handler._start_time, time_handler._execution_time)
    time_handler.reset()
    yield
    time_handler._start_time, time_handler._execution_time = saved


def _seed(codes=CODES, base_sym=()):
    return seed_frontier(codes, N_LANES, base_sym=base_sym,
                         max_conds=MAX_CONDS, arena_capacity=1 << 16,
                         const_capacity=1 << 12)


def _row_bytes(state, planes) -> int:
    return sum(int(np.dtype(leaf.dtype).itemsize) * int(np.prod(leaf.shape[1:]))
               for leaf in list(state) + list(planes))


def _jax_frontier(arena, row_bytes):
    frontier = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    frontier.telemetry_enabled = False
    frontier.state_merge = False
    frontier.arena = arena
    frontier.stack_bytes = frontier.esc_bytes = POOL_ROWS * row_bytes
    return frontier


def _port_frontier(arena, row_bytes, **kwargs):
    return tf.DeviceFrontier(N_LANES, device="cpu",
                             stack_bytes=POOL_ROWS * row_bytes,
                             esc_bytes=POOL_ROWS * row_bytes,
                             arena=to_port("arena", arena), **kwargs)


def _count_frozen(frontier):
    """Wrap the JAX frontier's frozen-lane deferral to count its lanes."""
    frozen = [0]
    defer = frontier._defer_lanes

    def counting(state, planes, lanes):
        frozen[0] += len(lanes)
        return defer(state, planes, lanes)

    frontier._defer_lanes = counting
    return frozen


def _same_blocks(jax_blocks, port_blocks):
    assert len(port_blocks) == len(jax_blocks)
    for number, (ref, got) in enumerate(zip(jax_blocks, port_blocks)):
        assert got[2] == ref[2] and got[3] == ref[3], number
        for part in (0, 1):
            assert sorted(got[part]) == sorted(ref[part]), number
            for field, array in ref[part].items():
                mine = got[part][field]
                assert mine.dtype == array.dtype and mine.shape == array.shape \
                    and np.array_equal(mine, array), f"block {number} {field}"


def _same_mirror(jax_mirror, port_mirror):
    assert (port_mirror.n, port_mirror.n_const) == (jax_mirror.n,
                                                    jax_mirror.n_const)
    for col in ta.ROW_COLS + ("const_vals",):
        ref, got = getattr(jax_mirror, col), getattr(port_mirror, col)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), col


# ---- the device programs on a mid-run state ----------------------------------------

@pytest.fixture(scope="module")
def mid_run():
    """(JAX trees, port trees) two chunks into the run, escapes buffered."""
    state, planes, arena = _seed()
    sched = jsym.new_scheduler(state, planes, POOL_ROWS, POOL_ROWS)
    for _ in range(2):
        state, planes, arena, sched = jsym.run_chunk(state, planes, arena,
                                                     sched, tf.CHUNK)
    jax_trees = np_tree((state, planes, arena, sched))
    port = tuple(to_port(kind, tree) for kind, tree in
                 zip(("state", "planes", "arena", "sched"), jax_trees))
    assert int(jax_trees[3].esc_count) > 0
    return jax_trees, port


def _indices(jax_trees):
    """The drain's escape-row index (zero padded) and a lane index padded
    by repeating its first entry, as the driver builds them."""
    esc_count = int(jax_trees[3].esc_count)
    bucket = jb.next_pow2(esc_count)
    escape = np.zeros(bucket, dtype=np.int32)
    escape[:esc_count] = np.arange(esc_count)
    lanes = np.asarray([3, 0, 7, 12, 5], dtype=np.int32)
    padded = np.full(8, lanes[0], dtype=np.int32)
    padded[:len(lanes)] = lanes
    return {"escape": escape, "lanes": padded}


def _source(kind, trees):
    """(state_like, planes_like) the index selects from."""
    state, planes, _, sched = trees
    if kind == "escape":
        return sched.esc_state, sched.esc_planes
    return state, planes


def test_summary_matches_jax(mid_run):
    jax_trees, port = mid_run
    ref = np.asarray(jf._summary(*jax_trees))
    got = tf.summary_reference(*port).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert got[1] > 0 and got[8] > 0  # live escape rows with memory


@pytest.mark.parametrize("kind", ["escape", "lanes"])
def test_row_maxima_matches_jax(mid_run, kind):
    jax_trees, port = mid_run
    index = _indices(jax_trees)[kind]
    ref = np.asarray(jf._row_maxima(*_source(kind, jax_trees), index))
    got = tf.row_maxima_reference(*_source(kind, port),
                                  torch.from_numpy(index)).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("kind", ["escape", "lanes"])
def test_pack_rows_and_unpack_match_jax(mid_run, kind):
    jax_trees, port = mid_run
    index = _indices(jax_trees)[kind]
    source = _source(kind, jax_trees)
    maxima = [int(v) for v in np.asarray(jf._row_maxima(*source, index))]
    widths = tf.pack_widths(*_source(kind, port), *maxima)
    ref = [np.asarray(part) for part in jf._pack_rows(
        *source, index, *widths)]
    got = [part.numpy() for part in tf.pack_rows_reference(
        *_source(kind, port), torch.from_numpy(index), *widths)]
    for name, mine, theirs in zip(("i32", "u8", "gas"), got, ref):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs), name
    ref_rows = jf._drain_unpack(*ref, len(index), *widths)
    got_rows = tf.drain_unpack(*got, len(index), *widths)
    _same_blocks([[*ref_rows, len(index), 0]], [[*got_rows, len(index), 0]])


def test_reset_esc_matches_jax(mid_run):
    jax_trees, port = mid_run
    sched = to_port("sched", jax_trees[3])
    ref = jf._reset_esc(jax_trees[3])
    assert_same(ref, tf.reset_esc_reference(sched))
    assert int(sched.esc_count) == 0


def test_gather_rows_matches_jax(mid_run):
    jax_trees, port = mid_run
    index = _indices(jax_trees)["lanes"]
    ref = jf._gather_rows(jax_trees[0], jax_trees[1], index)
    got = tf.gather_rows_reference(port[0], port[1], torch.from_numpy(index))
    assert_same(ref[0], got[0], "state.")
    assert_same(ref[1], got[1], "planes.")


def test_scatter_rows_matches_jax(mid_run):
    """Pending rows into DEAD lanes; pad entries (index = lanes) drop."""
    jax_trees, port = mid_run
    sched = jax_trees[3]
    source = np.asarray([2, 0, 1, 0], dtype=np.int32)  # row 3: the pad
    rows = np_tree(jf._gather_rows(sched.esc_state, sched.esc_planes, source))
    index = np.full(4, N_LANES, dtype=np.int32)
    index[:3] = [9, 4, 15]
    ref = jf._scatter_rows_compiled()(jax_trees[0], jax_trees[1], index, *rows)
    state, planes = to_port("state", jax_trees[0]), to_port("planes",
                                                            jax_trees[1])
    got = tf.scatter_rows_reference(
        state, planes, torch.from_numpy(index),
        to_port("state", rows[0]), to_port("planes", rows[1]))
    assert_same(ref[0], got[0], "state.")
    assert_same(ref[1], got[1], "planes.")


def test_pool_used_indices_matches_jax():
    for counts, rows in ((0, 8), (5, 8), (np.asarray([2, 0, 3]), 12)):
        ref = jf._Frontier._pool_used_indices(counts, rows)
        got = tf.pool_used_indices(counts, rows)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


# ---- seeding and sizing -------------------------------------------------------------

def test_seed_and_sched_match_jax_seeding():
    """`seed` gives the JAX frontier's seeded lanes at the default
    geometry; `new_sched` sizes the pools as `_new_sched` does."""
    seeds = [(CODES[0], {}, False, 10_000_000, 0),
             (CODES[1], {1: 7, 5: 2}, True, 5_000_000, 0xABC)]
    specs = [jb.LaneSpec(code=code, storage=storage, gas_limit=gas,
                         address=address)
             for code, storage, _, gas, address in seeds]
    specs += [jb.LaneSpec(code=b"\x00")] * (N_LANES - len(seeds))
    state = jb.build_batch(specs)
    status = np.full(N_LANES, jb.DEAD, dtype=np.int32)
    status[:2] = jb.RUNNING
    state = state._replace(status=status)
    planes = jsym.SymPlanes.empty(N_LANES, state.stack.shape[1],
                                  state.memory.shape[1],
                                  state.storage_keys.shape[1], jf.MAX_CONDS)
    base = np.zeros(N_LANES, dtype=bool)
    base[1] = True
    ctx = np.full(N_LANES, -1, dtype=np.int32)
    ctx[:2] = [0, 1]
    planes = planes._replace(storage_base_sym=base, ctx_id=ctx)

    port = tf.DeviceFrontier(N_LANES, device="cpu", stack_bytes=40 << 20,
                             esc_bytes=3 << 20)
    p_state, p_planes = port.seed(seeds)
    assert_same(state, p_state, "state.")
    assert_same(planes, p_planes, "planes.")
    frontier = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    frontier.telemetry_enabled = False
    frontier.stack_bytes, frontier.esc_bytes = 40 << 20, 3 << 20
    ref = frontier._new_sched(state, planes)
    got = port.new_sched(p_state, p_planes)
    assert got.stack_state.status.shape == ref.stack_state.status.shape
    assert got.esc_state.status.shape == ref.esc_state.status.shape
    assert port.row_bytes == frontier._row_bytes


# ---- the driver ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def drained():
    """Both drivers run from the same seeds until the tree drains."""
    state, planes, arena = _seed()
    row_bytes = _row_bytes(state, planes)
    frontier = _jax_frontier(arena, row_bytes)
    frozen = _count_frozen(frontier)
    port = _port_frontier(arena, row_bytes)
    frontier.run(state, planes)
    port.run(to_port("state", state), to_port("planes", planes))
    return frontier, frozen[0], port


def test_drain_loop_matches_jax(drained):
    frontier, frozen, port = drained
    _same_blocks(frontier.deferred, port.deferred)
    _same_mirror(frontier.harena, port.harena)
    for counter in ("lane_steps", "forks", "stack_pushes", "stack_pops",
                    "spilled", "reseeded"):
        assert getattr(port, counter) == getattr(frontier, counter), counter
    assert port.frozen_rows == frozen
    assert not port.pending and not frontier.pending
    assert tf.deferred_digest(port.deferred) \
        == tf.deferred_digest(frontier.deferred)
    assert tf.mirror_digest(port.harena) == tf.mirror_digest(frontier.harena)


def test_drain_loop_takes_every_path(drained):
    """The comparison is worth something only if the run deferred frozen
    lanes, spilled at a deadlock, reseeded from the host tier and drained
    every path: one deferred row per leaf or unexplored sibling."""
    frontier, frozen, port = drained
    assert frozen > 0 and port.spilled > 0 and port.reseeded > 0
    assert port.drains > 0 and port.drained_rows > 0
    assert sum(block[2] for block in port.deferred) == port.forks + 2


def test_hand_over_matches_jax(monkeypatch):
    """A step budget of two chunks: live lanes, both pools and the host
    tier are packed into `deferred` as the JAX hand-over fetches them (its
    per-lane materialization replaced by the same deferral)."""
    monkeypatch.setenv("MYTHRIL_TPU_MAX_STEPS", str(2 * tf.CHUNK))
    state, planes, arena = _seed()
    row_bytes = _row_bytes(state, planes)
    frontier = _jax_frontier(arena, row_bytes)
    monkeypatch.setattr(
        frontier, "_materialize_lanes",
        lambda state, planes, harena, lanes: frontier._defer_lanes(
            state, planes, lanes))
    port = _port_frontier(arena, row_bytes, max_steps=2 * tf.CHUNK)
    frontier.run(state, planes)
    port.run(to_port("state", state), to_port("planes", planes))
    assert port.chunks == 2
    _same_blocks(frontier.deferred, port.deferred)
    _same_mirror(frontier.harena, port.harena)
    assert sum(block[2] for block in port.deferred) > port.drained_rows


def test_cold_sload_needs_a_service():
    """KILLBILLY's SLOAD on a symbolic-base storage pauses its lane: with
    no `service_cold` hook the driver refuses; a hook gets the lane."""
    codes = [assemble(dispatcher(KILLBILLY))]
    state, planes, arena = _seed(codes, base_sym=[0])
    row_bytes = _row_bytes(state, planes)
    port = _port_frontier(arena, row_bytes)
    with pytest.raises(NotImplementedError, match="cold-SLOAD"):
        port.run(to_port("state", state), to_port("planes", planes))

    seen = []

    def service(frontier, p_state, p_planes, status, lanes):
        seen.extend(lanes)
        status[lanes] = tb.DEAD  # hand the lanes to the host engine
        return p_state, p_planes

    port = _port_frontier(arena, row_bytes, service_cold=service)
    port.run(to_port("state", state), to_port("planes", planes))
    assert seen and port.harena is not None
    assert port.harena.n <= int(port.arena.n)


def test_driver_defaults_follow_the_jax_knobs():
    port = tf.DeviceFrontier(device="cpu", arena=ta.new_arena(64, 16,
                                                              device="cpu"))
    assert (port.n_lanes, port.chunk, port.max_steps) == (
        jf.DEFAULT_LANES, jf.CHUNK, jf.MAX_STEPS)
    assert (port.stack_bytes, port.esc_bytes) == (3 << 30, 1 << 30)
    assert port.drain_batch == max(4 * jf.DEFAULT_LANES, 1024)
    assert (tf.ARENA_HEADROOM, tf.MAX_CONDS) == (jf.ARENA_HEADROOM,
                                                 jf.MAX_CONDS)
    assert tf._DRAIN_I32_FIELDS == jf._DRAIN_I32_FIELDS


# ---- chip_smoke.py's reference constants ----------------------------------------------

@pytest.mark.parametrize("which", ["frontier", "spill"])
def test_chip_smoke_constants_are_the_jax_drain(which, monkeypatch):
    """chip_smoke.py holds the port's drain loop on the card to constants:
    the JAX `_Frontier`'s drain of dispatcher(branchy(n)) from one seed at
    the default geometry and budgets (128 lanes, branchy(12)), and of the
    reduced-pool run (16 lanes, 32 stack rows, branchy(10)). Recompute
    both here with JAX."""
    import chip_smoke

    if which == "frontier":
        n_lanes, branches, expected = (chip_smoke.LANES, chip_smoke.N_BRANCHES,
                                       chip_smoke.EXPECTED_FRONTIER)
    else:
        n_lanes, branches, expected = (chip_smoke.SPILL_LANES,
                                       chip_smoke.SPILL_BRANCHES,
                                       chip_smoke.EXPECTED_SPILL)
    code = assemble(dispatcher({"stress()": branchy_contract(branches)}))
    specs = [jb.LaneSpec(code=code, gas_limit=10_000_000)]
    specs += [jb.LaneSpec(code=b"\x00")] * (n_lanes - 1)
    state = jb.build_batch(specs)
    status = np.full(n_lanes, jb.DEAD, dtype=np.int32)
    status[0] = jb.RUNNING
    state = state._replace(status=status)
    planes = jsym.SymPlanes.empty(n_lanes, state.stack.shape[1],
                                  state.memory.shape[1],
                                  state.storage_keys.shape[1], jf.MAX_CONDS)
    ctx = np.full(n_lanes, -1, dtype=np.int32)
    ctx[0] = 0
    planes = planes._replace(ctx_id=ctx)

    frontier = jf._Frontier(laser_evm=None, n_lanes=n_lanes)
    frontier.telemetry_enabled = False
    frontier.state_merge = False
    if which == "spill":
        frontier.stack_bytes = chip_smoke.SPILL_STACK_ROWS \
            * _row_bytes(state, planes)
    frozen = _count_frozen(frontier)
    counts = {"chunks": 0, "drains": 0, "drained_rows": 0}
    run_chunk, fetch = jsym.run_chunk, frontier._fetch_escapes

    def counting_chunk(*args):
        counts["chunks"] += 1
        return run_chunk(*args)

    def counting_fetch(*args):
        backlog = fetch(*args)
        counts["drains"] += 1
        counts["drained_rows"] += backlog[2]
        return backlog

    monkeypatch.setattr(jsym, "run_chunk", counting_chunk)
    frontier._fetch_escapes = counting_fetch
    frontier.run(state, planes)
    got = {**counts, "frozen_rows": frozen[0], "spilled": frontier.spilled,
           "reseeded": frontier.reseeded, "lane_steps": frontier.lane_steps,
           "forks": frontier.forks, "stack_pushes": frontier.stack_pushes,
           "stack_pops": frontier.stack_pops,
           "deferred_blocks": len(frontier.deferred),
           "deferred_rows": sum(block[2] for block in frontier.deferred),
           "mirror_n": frontier.harena.n,
           "mirror_n_const": frontier.harena.n_const,
           "deferred_sha256": tf.deferred_digest(frontier.deferred),
           "mirror_sha256": tf.mirror_digest(frontier.harena)}
    assert got == expected
