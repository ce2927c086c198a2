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

import json

import numpy as np
import pytest
import torch

from _torch_parity import (assert_same, jax_static_tables, np_tree,
                           seed_frontier, to_port)
from bench import _mem_branchy_contract
from chip_smoke import PLANES_SOURCE, branchy_contract
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import batch as jb
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch import staticanalysis as sa
from mythril_tpu_torch.parallel import arena as ta
from mythril_tpu_torch.parallel import batch as tb
from mythril_tpu_torch.parallel import frontier as tf
from mythril_tpu_torch.support import support_args
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
    kwargs = {"telemetry": False, "state_merge": False, **kwargs}
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
    # telemetry and state merging are on by default, as the JAX knobs are
    frontier = jf._Frontier(laser_evm=None, n_lanes=jf.DEFAULT_LANES)
    assert (port.telemetry, port.state_merge) == (
        frontier.telemetry_enabled, frontier.state_merge) == (True, True)
    assert tf.MERGE_MIN_LANES == frontier.merge_min_lanes
    assert (tf.TAG_SLOTS, tf.MERGE_PC_SLOTS, tf.MERGE_ROUNDS) == (
        jf._Frontier.TAG_SLOTS, jf._Frontier.MERGE_PC_SLOTS,
        jf._MERGE_ROUNDS)


# ---- the default configuration: telemetry and state merging on -------------------

DEFAULT_BODIES = {"branchy9": branchy_contract(9),
                  "mem_branchy8": _mem_branchy_contract(8)}


#: chunk of the default-configuration runs: at 16 lanes and 64-step chunks
#: fork siblings rarely share lanes at a chunk's end, so nothing merges
DEFAULT_CHUNK = 8


@pytest.fixture(scope="module", params=sorted(DEFAULT_BODIES))
def default_run(request):
    """Both drivers with telemetry and merging on, 8-step chunks, the JAX
    one handed the tables its static analysis builds for the contract, the
    port the same arrays. Returns (name, JAX frontier, its merge stats
    vectors, port)."""
    code = assemble(dispatcher({"stress()": DEFAULT_BODIES[request.param]}))
    state, planes, arena = _seed([code])
    row_bytes = _row_bytes(state, planes)
    tags, merge_table = jax_static_tables([code])
    frontier = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    assert frontier.telemetry_enabled and frontier.state_merge
    frontier.arena = arena
    frontier.stack_bytes = frontier.esc_bytes = POOL_ROWS * row_bytes
    frontier._collect_tag_pcs = lambda: tags
    frontier._merge_pc_table = lambda: merge_table
    mstats = []
    publish = frontier._publish_merge

    def recording(stats, names):
        mstats.append(np.asarray(stats))
        return publish(stats, names)

    frontier._publish_merge = recording
    merge_pcs, merge_names, mem_pcs, mem_words = merge_table
    port = _port_frontier(arena, row_bytes, telemetry=True, state_merge=True,
                          chunk=DEFAULT_CHUNK, tag_pcs=tags[0],
                          tag_names=tags[1], merge_pcs=merge_pcs,
                          merge_names=merge_names, mem_pcs=mem_pcs,
                          mem_words=mem_words)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("MYTHRIL_TPU_CHUNK", str(DEFAULT_CHUNK))
        frontier.run(state, planes)
    port.run(to_port("state", state), to_port("planes", planes))
    return request.param, frontier, mstats, port


def test_default_configuration_matches_jax(default_run):
    """Deferred rows, mirror, counters, every merge pass's totals and the
    final telemetry words equal the JAX frontier's."""
    name, frontier, mstats, port = default_run
    _same_blocks(frontier.deferred, port.deferred)
    _same_mirror(frontier.harena, port.harena)
    for counter in ("lane_steps", "forks", "stack_pushes", "stack_pops",
                    "spilled", "reseeded", "merges"):
        assert getattr(port, counter) == getattr(frontier, counter), counter
    assert port.merge_passes == len(mstats)
    total = np.sum(mstats, axis=0) if mstats else np.zeros(8, np.int64)
    assert (port.merges, port.merge_ites, port.mem_blends) == tuple(
        int(v) for v in total[:3])
    assert list(port.blocked_by.values()) == [int(v) for v in total[3:8]]
    assert np.array_equal(port.tel_words, frontier._tel_prev)
    assert port.tag_names == frontier.tag_names


def test_default_configuration_takes_its_paths(default_run):
    """branchy(9) has no merge points: passes run on the 4-chunk cadence
    and merge strictly. mem_branchy(8) has 8 tagged joins: the tag deltas
    trigger the passes and the widened rounds blend memory."""
    name, frontier, mstats, port = default_run
    assert port.merge_passes > 0 and port.merges > 0
    if name == "branchy9":
        assert not port.tag_names and port.mem_blends == 0
        assert port.merge_passes <= port.chunks // 4
    else:
        assert len(port.tag_names) == 8 and port.mem_blends > 0
        assert sum(port.tag_merges.values()) == port.merges
    assert port.op_hist.sum() == port.lane_steps
    assert port.lifecycle[jsym.LIFECYCLE_NAMES.index("reseeds")] \
        == port.stack_pops


def test_telemetry_off_null():
    """With merging off, the plane changes no result and no read: the same
    number of summaries, the same deferred rows and mirror, on and off."""
    state, planes, arena = _seed()
    row_bytes = _row_bytes(state, planes)
    runs = {}
    for telemetry in (False, True):
        reads = [0]
        port = _port_frontier(arena, row_bytes, telemetry=telemetry)
        summary = tf.summary

        def counting(*args):
            reads[0] += 1
            return summary(*args)

        tf.summary = counting
        try:
            port.run(to_port("state", state), to_port("planes", planes))
        finally:
            tf.summary = summary
        runs[telemetry] = (reads[0], tf.deferred_digest(port.deferred),
                           tf.mirror_digest(port.harena), port.lane_steps)
    assert runs[True] == runs[False] and runs[True][0] > 0


# ---- chip_smoke.py's reference constants ----------------------------------------------

@pytest.mark.parametrize("which", ["frontier", "spill", "default", "merge",
                                   "shard", "fleet", "wide"])
def test_chip_smoke_constants_are_the_jax_drain(which, monkeypatch):
    """chip_smoke.py holds the port's drain loop on the card to constants:
    the JAX `_Frontier`'s drain of dispatcher(branchy(n)) from one seed at
    the default geometry and budgets (128 lanes, branchy(12)), of the
    reduced-pool run (16 lanes, 32 stack rows, branchy(10)), both with
    telemetry and merging off, and of the default configuration (both on)
    on branchy(12) and on mem_branchy(8) with the tables the JAX static
    analysis builds for it, and on branchy(12) at 2048 lanes (phase
    frontier_wide); and of the sharded frontier (4 shards, the default
    steal knobs, `n_shards` set on the instance): branchy(12) from one
    seed in shard 0, and the two-member fleet of branchy(12) and
    mem_branchy(8) seeded in shards 0 and 2 with fleet slots [0, 1] and
    the tables of both codes. Recompute all seven here with JAX."""
    import chip_smoke

    if which == "fleet":
        names = list(chip_smoke.FLEET_RUN)
        bodies = [chip_smoke.FLEET_RUN[name] for name in names]
        codes = [assemble(dispatcher({"stress()": body})) for body in bodies]
        _check_sharded_constants(chip_smoke, codes, chip_smoke.EXPECTED_FLEET,
                                 chip_smoke.FLEET_OWNERS, names, monkeypatch)
        return
    if which == "shard":
        code = assemble(dispatcher({"stress()": branchy_contract(
            chip_smoke.N_BRANCHES)}))
        _check_sharded_constants(chip_smoke, [code], chip_smoke.EXPECTED_SHARD,
                                 None, None, monkeypatch)
        return
    runs = {
        "frontier": (chip_smoke.LANES, branchy_contract(chip_smoke.N_BRANCHES),
                     chip_smoke.EXPECTED_FRONTIER, False),
        "spill": (chip_smoke.SPILL_LANES,
                  branchy_contract(chip_smoke.SPILL_BRANCHES),
                  chip_smoke.EXPECTED_SPILL, False),
        "default": (chip_smoke.LANES, branchy_contract(chip_smoke.N_BRANCHES),
                    chip_smoke.EXPECTED_DEFAULT, True),
        "merge": (chip_smoke.LANES,
                  _mem_branchy_contract(chip_smoke.MERGE_BRANCHES),
                  chip_smoke.EXPECTED_MERGE, True),
        "wide": (chip_smoke.WIDE_LANES, branchy_contract(chip_smoke.N_BRANCHES),
                 chip_smoke.EXPECTED_WIDE, True)}
    n_lanes, body, expected, default = runs[which]
    code = assemble(dispatcher({"stress()": body}))
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
    assert frontier.telemetry_enabled and frontier.state_merge
    frontier.telemetry_enabled = frontier.state_merge = default
    if which == "spill":
        frontier.stack_bytes = chip_smoke.SPILL_STACK_ROWS \
            * _row_bytes(state, planes)
    mstats = []
    if default:
        tags, merge_table = jax_static_tables([code])
        frontier._collect_tag_pcs = lambda: tags
        frontier._merge_pc_table = lambda: merge_table
        publish = frontier._publish_merge

        def recording(stats, names):
            mstats.append(np.asarray(stats))
            return publish(stats, names)

        frontier._publish_merge = recording
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
    if default:
        total = np.sum(mstats, axis=0) if mstats else np.zeros(8, np.int64)
        got.update({"merge_passes": len(mstats), "merges": frontier.merges,
                    "merge_ites": int(total[1]), "mem_blends": int(total[2]),
                    "blocked_by": dict(zip(jsym.MERGE_BLOCKED_LABELS,
                                           (int(v) for v in total[3:8]))),
                    "telemetry_words": [int(v) for v in frontier._tel_prev]})
    assert got == expected, json.dumps(got, sort_keys=True)


def test_chip_smoke_tables_are_the_jax_analysis():
    """chip_smoke.py's copy of bench.py's memory diamonds, and the tag and
    window tables it hard-codes for them, are what bench.py and the JAX
    static analysis give."""
    import chip_smoke

    for n in (1, 4, chip_smoke.MERGE_BRANCHES):
        assert chip_smoke.mem_branchy_contract(n) == _mem_branchy_contract(n)
    code = assemble(dispatcher({"stress()": _mem_branchy_contract(
        chip_smoke.MERGE_BRANCHES)}))
    (tag_pcs, tag_names), (merge_pcs, merge_names, mem_pcs, mem_words) = \
        jax_static_tables([code])
    tables = chip_smoke.mem_branchy_tables()
    assert tables["tag_pcs"] == list(tag_pcs)
    assert tables["tag_names"] == list(tag_names)
    assert tables["merge_pcs"] == [int(pc) for pc in merge_pcs]
    assert tables["merge_names"] == list(merge_names)
    assert tables["mem_pcs"] == mem_pcs.tolist()
    assert tables["mem_words"] == mem_words.tolist()


# ---- the tables the port builds for itself -----------------------------------------

def _jax_tables(codes) -> dict:
    """`jax_static_tables(codes)` keyed as `static_tables` returns them."""
    tags, merge_table = jax_static_tables(codes)
    return dict(zip(tf.TABLE_KEYS, (*tags, *merge_table)))


def _same_tables(got: dict, expected: dict) -> None:
    """Every table equal, its type, dtype and shape too."""
    assert set(got) == set(expected) == set(tf.TABLE_KEYS)
    for key in tf.TABLE_KEYS:
        mine, theirs = got[key], expected[key]
        assert type(mine) is type(theirs), key
        if isinstance(theirs, np.ndarray):
            assert mine.dtype == theirs.dtype and mine.shape == theirs.shape \
                and np.array_equal(mine, theirs), key
        else:
            assert list(mine) == list(theirs), key


def _static_cases() -> dict:
    """name -> codes in seed order: chip_smoke's static_tables sets (loops
    beside joins and 40 diamonds past the 32 tags and 64 window rows among
    them), the planes contract, two codes whose joins differ, and the
    corpus."""
    import chip_smoke
    import test_cfa

    def stress(body):
        return assemble(dispatcher({"stress()": body}))

    cases = dict(chip_smoke.static_codes())
    cases["planes"] = [CODES[1]]
    cases["two_codes"] = [stress(_mem_branchy_contract(2)),
                          stress(_mem_branchy_contract(5)),
                          stress(_mem_branchy_contract(2))]
    for name, code_hex in test_cfa._corpus_bytecodes():
        cases[f"corpus_{name}"] = [bytes.fromhex(code_hex.removeprefix("0x"))]
    return cases


STATIC_CASES = _static_cases()


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_static_tables_match_jax(case):
    """`static_tables(codes)` is what the JAX `_collect_tag_pcs` and
    `_merge_pc_table` build over contexts running `codes`."""
    codes = STATIC_CASES[case]
    expected = _jax_tables(codes)
    _same_tables(tf.static_tables(codes), expected)
    if case == "past_the_caps":
        assert len(expected["tag_pcs"]) == tf.TAG_SLOTS
        assert len(expected["mem_pcs"]) == tf.MERGE_PC_SLOTS
        assert len(expected["merge_pcs"]) == 40
    if case == "loops_and_joins":
        assert expected["tag_names"][0].startswith("loop@")
        assert expected["tag_names"][-1].startswith("merge@")


@pytest.mark.parametrize("off", ["telemetry", "state_merge", "absint"])
def test_static_tables_switched_off(off, monkeypatch):
    """Telemetry off: no tags; merging off: no merge tables (JAX
    frontier.py:733, 1133-1137); absint off: no window table, the JAX
    frontier under MYTHRIL_TPU_ABSINT=0."""
    codes = STATIC_CASES["mem_branchy8"]
    if off == "absint":
        monkeypatch.setenv("MYTHRIL_TPU_ABSINT", "0")
    expected = _jax_tables(codes)
    if off == "telemetry":
        expected.update(tag_pcs=[], tag_names=[])
    if off == "state_merge":
        expected.update(merge_pcs=np.zeros(0, np.int32), merge_names=[],
                        mem_pcs=np.zeros(0, np.int32),
                        mem_words=np.zeros((0, 1), np.int32))
    got = tf.static_tables(codes, **{off: False})
    _same_tables(got, expected)
    assert len(got["tag_pcs"]) == (0 if off == "telemetry" else 8)
    assert len(got["mem_pcs"]) == (37 if off == "telemetry" else 0)


def test_seed_builds_the_tables_and_drives_the_same(default_run):
    """A DeviceFrontier handed no tables builds the JAX analysis's in
    `seed`, keeps K10's table tensors for the whole run, and drives as the
    one handed the tables and as the JAX frontier do."""
    name, frontier, mstats, hand_fed = default_run
    code = assemble(dispatcher({"stress()": DEFAULT_BODIES[name]}))
    state, planes, arena = _seed([code])
    port = _port_frontier(arena, _row_bytes(state, planes), telemetry=True,
                          state_merge=True, chunk=DEFAULT_CHUNK)
    assert port.own_tables and not hand_fed.own_tables
    assert not port.tag_pcs and not len(port.mem_pcs)
    port.seed([(code, {}, False, 10_000_000, 0)])
    _same_tables(port.tables(), _jax_tables([code]))
    tensors = port.merge_tables
    port.run(to_port("state", state), to_port("planes", planes))
    assert port.merge_tables is tensors
    _same_blocks(frontier.deferred, port.deferred)
    _same_mirror(frontier.harena, port.harena)
    for counter in ("lane_steps", "forks", "stack_pushes", "stack_pops",
                    "merge_passes", "merges", "merge_ites", "mem_blends",
                    "blocked_by", "tag_merges", "ite_depth"):
        assert getattr(port, counter) == getattr(hand_fed, counter), counter
    assert np.array_equal(port.tel_words, hand_fed.tel_words)
    assert np.array_equal(port.tel_words, frontier._tel_prev)
    assert port.tag_names == frontier.tag_names
    if name == "mem_branchy8":
        assert port.mem_blends > 0 and port.merges > 0


def test_absint_off_blocks_the_memory_merge(monkeypatch):
    """With absint off (`--no-absint`) the frontier builds no window table,
    and the diverged memory planes of mem_branchy(8)'s arms block their
    merges (blocked_by memory, as tests/test_absint.py's A/B run counts)."""
    monkeypatch.setattr(support_args.args, "absint", False)
    code = assemble(dispatcher({"stress()": DEFAULT_BODIES["mem_branchy8"]}))
    state, planes, arena = _seed([code])
    port = _port_frontier(arena, _row_bytes(state, planes), telemetry=True,
                          state_merge=True, chunk=DEFAULT_CHUNK)
    port.seed([(code, {}, False, 10_000_000, 0)])
    assert port.mem_pcs.shape == (0,) and port.mem_words.shape == (0, 1)
    assert len(port.merge_pcs) == len(port.tag_pcs) == 8
    port.run(to_port("state", state), to_port("planes", planes))
    assert port.merge_passes > 0 and port.mem_blends == 0
    assert port.blocked_by["memory"] > 0


def test_switch_off_does_not_outlive_its_frontier(monkeypatch):
    """A frontier seeded with the CFA switched off builds no tables; its
    Disassemblies, and the bail verdicts memoized on them, are its own, so
    frontiers and `static_tables` calls after the switch is back on build
    the JAX analysis's tables."""
    codes = STATIC_CASES["mem_branchy8"]
    seeds = [(code, {}, False, 10_000_000, 0) for code in codes]
    monkeypatch.setitem(sa.ENABLED, "cfa", False)
    off = tf.DeviceFrontier(N_LANES, device="cpu")
    off.seed(seeds)
    assert not off.tag_pcs and not len(off.merge_pcs) \
        and not len(off.mem_pcs)
    assert not tf.static_tables(codes)["tag_pcs"]
    monkeypatch.setitem(sa.ENABLED, "cfa", True)
    expected = _jax_tables(codes)
    _same_tables(tf.static_tables(codes), expected)
    on = tf.DeviceFrontier(N_LANES, device="cpu")
    on.seed(seeds)
    _same_tables(on.tables(), expected)


def test_chip_smoke_static_tables_are_the_jax_analysis():
    """chip_smoke.py's static_tables constants, recomputed with JAX."""
    import chip_smoke

    for name, codes in chip_smoke.static_codes().items():
        assert chip_smoke.table_counts(_jax_tables(codes)) \
            == chip_smoke.EXPECTED_STATIC[name], name
    branchy = chip_smoke.static_codes()["branchy12"]
    assert {key: np.asarray(value).tolist()
            for key, value in _jax_tables(branchy).items()} \
        == chip_smoke.NO_TABLES


def _counting_drain(frontier, monkeypatch):
    """Wrap run_chunk and _fetch_escapes to count chunks and drains; wrap
    the merge publication to keep each pass's stats vector."""
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
    mstats = []
    publish = frontier._publish_merge

    def recording(stats, names):
        mstats.append(np.asarray(stats))
        return publish(stats, names)

    frontier._publish_merge = recording
    return counts, mstats


def _check_sharded_constants(chip_smoke, codes, expected, owners, fleet_names,
                             monkeypatch):
    """The sharded default-configuration drain of `codes` (seed i owned by
    shard owners[i], round robin without owners) with JAX, against
    chip_smoke's constants."""
    n_lanes = chip_smoke.LANES
    frontier = jf._Frontier(laser_evm=None, n_lanes=n_lanes)
    assert frontier.telemetry_enabled and frontier.state_merge
    assert (frontier.steal_cadence, frontier.steal_min_imbalance) == (
        tf.STEAL_CADENCE, tf.STEAL_MIN_IMBALANCE)
    frontier.n_shards = chip_smoke.SHARDS
    frontier._seed_owner_index = owners
    lanes = frontier._assign_seed_lanes(len(codes))
    specs = [jb.LaneSpec(code=b"\x00")] * n_lanes
    for lane, code in zip(lanes, codes):
        specs[lane] = jb.LaneSpec(code=code, gas_limit=10_000_000)
    state = jb.build_batch(specs)
    status = np.full(n_lanes, jb.DEAD, dtype=np.int32)
    status[lanes] = jb.RUNNING
    state = state._replace(status=status)
    planes = jsym.SymPlanes.empty(n_lanes, state.stack.shape[1],
                                  state.memory.shape[1],
                                  state.storage_keys.shape[1], jf.MAX_CONDS)
    ctx = np.full(n_lanes, -1, dtype=np.int32)
    ctx[lanes] = np.arange(len(codes))
    planes = planes._replace(ctx_id=ctx)
    tags, merge_table = jax_static_tables(codes)
    frontier._collect_tag_pcs = lambda: tags
    frontier._merge_pc_table = lambda: merge_table
    # the port's frontier builds these for itself on the card
    _same_tables(tf.static_tables(codes), _jax_tables(codes))
    if fleet_names is not None:
        frontier._collect_fleet_slots = lambda: (list(range(len(codes))),
                                                 list(fleet_names))
        tables = chip_smoke.fleet_tables()
        assert tables["tag_pcs"] == list(tags[0])
        assert tables["tag_names"] == list(tags[1])
        assert tables["merge_pcs"] == [int(pc) for pc in merge_table[0]]
        assert tables["merge_names"] == list(merge_table[1])
        assert tables["mem_pcs"] == merge_table[2].tolist()
        assert tables["mem_words"] == merge_table[3].tolist()
    frozen = _count_frozen(frontier)
    counts, mstats = _counting_drain(frontier, monkeypatch)
    frontier.run(state, planes)
    total = np.sum(mstats, axis=0) if mstats else np.zeros(8, np.int64)
    sent, recv, moved = frontier._shard_steals
    got = {**counts, "frozen_rows": frozen[0], "spilled": frontier.spilled,
           "reseeded": frontier.reseeded, "lane_steps": frontier.lane_steps,
           "forks": frontier.forks, "stack_pushes": frontier.stack_pushes,
           "stack_pops": frontier.stack_pops,
           "deferred_blocks": len(frontier.deferred),
           "deferred_rows": sum(block[2] for block in frontier.deferred),
           "mirror_n": frontier.harena.n,
           "mirror_n_const": frontier.harena.n_const,
           "deferred_sha256": tf.deferred_digest(frontier.deferred),
           "mirror_sha256": tf.mirror_digest(frontier.harena),
           "merge_passes": len(mstats), "merges": frontier.merges,
           "merge_ites": int(total[1]), "mem_blends": int(total[2]),
           "blocked_by": dict(zip(jsym.MERGE_BLOCKED_LABELS,
                                  (int(v) for v in total[3:8]))),
           "telemetry_words": [int(v) for v in frontier._tel_prev],
           "steal_passes": frontier._steal_passes,
           "steals_sent": [int(v) for v in sent],
           "steals_received": [int(v) for v in recv], "steal_rows": int(moved)}
    assert got == expected, json.dumps(got, sort_keys=True)
