"""The port's sharded frontier (n_shards > 1) against the JAX package's,
exactly.

* `new_scheduler(n_shards=D)`: vector tops and steal counters, and the
  refusal of pools that do not divide;
* the segmented step: `run_chunk_reference` against JAX `run_chunk` leaf
  for leaf after every chunk, 16 lanes, D = 2 and 4, telemetry off and
  on, with seeds in some blocks only so that one pool segment fills while
  another has room, and claims, pushes, spills and escapes reached;
* the summary's shard tail, the steal-row codec and `steal_pass_reference`
  against `_summary`, `_pack_steal_rows`/`_unpack_steal_rows` and
  `_steal_pass` (forced imbalance, below the threshold, D = 3, tied
  loads, short receiver room, a mid-run state);
* a two-chunk budget's hand-over of `DeviceFrontier(16, device="cpu",
  n_shards=2)` against the JAX `_Frontier`'s.

The sharded driver's full drives against JAX are in
tests/test_torch_shard_driver.py, a file of its own, so that `--dist
loadfile` gives them a worker of their own."""

import numpy as np
import pytest
import torch

# unspent_time_budget: autouse, the JAX driver's time budget disarmed
from _torch_drain import row_bytes_of, unspent_time_budget  # noqa: F401
from _torch_parity import SMALL, assert_same, np_tree, to_port
from chip_smoke import PLANES_SOURCE, branchy_contract
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import arena as jarena
from mythril_tpu.parallel import batch as jbatch
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import frontier as tf
from mythril_tpu_torch.parallel import symstep as tsym
from test_analysis import KILLBILLY
from test_fleet_shard import _filled, _lane_batch

N_LANES = 16
MAX_CONDS = 16
CHUNK = 12
N_CHUNKS = 8
BRANCHY5 = assemble(dispatcher({"stress()": branchy_contract(5)}))
PLANES = assemble(dispatcher({"planes()": PLANES_SOURCE}))
KILL = assemble(dispatcher(KILLBILLY))
KINDS = ("state", "planes", "arena", "sched")


def seed_lanes(placed, n_lanes=N_LANES, base_sym=(), arena_capacity=1 << 12):
    """JAX-side lanes with `placed` = {lane: code} RUNNING (ctx_id = the
    order in `placed`), the rest DEAD fillers, and a fresh arena."""
    specs = [jbatch.LaneSpec(code=b"\x00")] * n_lanes
    for lane, code in placed.items():
        specs[lane] = jbatch.LaneSpec(code=code, gas_limit=10_000_000)
    state = jbatch.build_batch(specs, **SMALL)
    status = np.full(n_lanes, jbatch.DEAD, dtype=np.int32)
    ctx = np.full(n_lanes, -1, dtype=np.int32)
    for index, lane in enumerate(placed):
        status[lane] = jbatch.RUNNING
        ctx[lane] = index
    state = state._replace(status=status)
    planes = jsym.SymPlanes.empty(n_lanes, SMALL["stack_slots"],
                                  SMALL["memory_bytes"],
                                  SMALL["storage_slots"], MAX_CONDS)
    base = np.zeros(n_lanes, dtype=bool)
    base[list(base_sym)] = True
    planes = planes._replace(ctx_id=ctx, storage_base_sym=base)
    return state, planes, jarena.new_arena(arena_capacity, 1 << 8)


# ---- the scheduler ----------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
def test_new_scheduler_shapes_match_jax(n_shards):
    state, planes, _ = seed_lanes({0: BRANCHY5})
    ref = jsym.new_scheduler(state, planes, 8, 4 * n_shards,
                             n_shards=n_shards)
    got = tsym.new_scheduler(to_port("state", state),
                             to_port("planes", planes), 8, 4 * n_shards,
                             n_shards=n_shards)
    assert_same(ref, got)
    assert tuple(got.stack_top.shape) == (n_shards,)
    assert got.steal_rows.dim() == 0
    with pytest.raises(ValueError):
        tsym.new_scheduler(to_port("state", state), to_port("planes", planes),
                           8, 6, n_shards=4)


# ---- the segmented step -----------------------------------------------------------

#: seeds per shard count: block 0 gets the branchy contract twice (its
#: segment fills), the planes and KILLBILLY contracts sit in other blocks
SEEDINGS = {2: {0: BRANCHY5, 1: BRANCHY5, 9: PLANES, 12: KILL},
            4: {0: BRANCHY5, 1: BRANCHY5, 9: PLANES, 13: KILL}}


def _trace(n_shards, telemetry):
    """(JAX trees, port trees) after each chunk; escape counts zeroed
    between chunks as the frontier's drain does."""
    placed = SEEDINGS[n_shards]
    state, planes, arena = seed_lanes(placed, base_sym=[13 if n_shards == 4
                                                        else 12])
    tel = None
    if telemetry:
        tel = jsym.new_telemetry([5, 13, 0x1B], fleet_slots=[0, 0, 1, 1],
                                 n_fleet=2)
    sched = jsym.new_scheduler(state, planes, 4 * n_shards, 6 * n_shards,
                               telemetry=tel, n_shards=n_shards)
    port = [to_port(kind, tree) for kind, tree in
            zip(KINDS, (state, planes, arena, sched))]
    trace = []
    for _ in range(N_CHUNKS):
        state, planes, arena, sched = jsym.run_chunk(state, planes, arena,
                                                     sched, CHUNK)
        port = list(tsym.run_chunk_reference(*port, CHUNK))
        trace.append((np_tree((state, planes, arena, sched)),
                      [convert.clone(t) for t in port]))
        sched = sched._replace(esc_count=np.zeros(n_shards, np.int32))
        port[3].esc_count.zero_()
    return trace


@pytest.fixture(scope="module", params=[(2, False), (2, True), (4, False),
                                        (4, True)],
                ids=["d2", "d2-tel", "d4", "d4-tel"])
def shard_trace(request):
    n_shards, telemetry = request.param
    return n_shards, telemetry, _trace(n_shards, telemetry)


def test_segmented_run_chunk_matches_jax(shard_trace):
    _, _, trace = shard_trace
    for number, (ref, got) in enumerate(trace):
        for kind, mine, theirs in zip(KINDS, got, ref):
            assert_same(theirs, mine, f"chunk {number} {kind}.")


def test_segmented_run_chunk_reaches_every_placement(shard_trace):
    """The run claimed, pushed, spilled and escaped per segment, and a
    segment of the stack was full while another had room."""
    n_shards, _, trace = shard_trace
    seg_pool = 4
    full_beside_room = False
    spilled = 0
    for ref, _ in trace:
        tops = np.asarray(ref[3].stack_top)
        full_beside_room |= bool((tops == seg_pool).any()
                                 and (tops < seg_pool).any())
        esc = np.asarray(ref[3].esc_count)
        status = np.asarray(ref[3].esc_state.status)
        for d in range(n_shards):
            rows = status[6 * d:6 * d + int(esc[d])]
            spilled += int((rows == jbatch.RUNNING).sum())
    last = trace[-1][0][3]
    assert full_beside_room and spilled > 0
    assert int(last.pushes) > 0 and int(last.pops) > 0
    assert int(last.forks) > int(last.pushes) + spilled  # claims too
    assert sum(int(np.asarray(t[0][3].esc_count).sum()) for t in trace) \
        > spilled


def test_summary_shard_tail_matches_jax(shard_trace):
    n_shards, telemetry, trace = shard_trace
    ref_trees, port_trees = trace[2]
    ref = np.asarray(jf._summary(*ref_trees))
    got = tf.summary_reference(*port_trees).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    tail = got[-(4 * n_shards + 1):]
    assert tail[:n_shards].sum() == got[0] and \
        tail[n_shards:2 * n_shards].sum() == got[1]


# ---- the steal-row codec and the steal pass -----------------------------------------

def test_steal_codec_matches_jax_and_round_trips():
    state, planes = _lane_batch(6)
    state, planes = _filled(state, seed=3), _filled(planes, seed=11)
    index = np.asarray([4, 2, 5], dtype=np.int32)
    widths = dict(mem_b=64, sp_b=8, st_b=4, conds_w=4)
    ref = [np.asarray(part) for part in
           jf._pack_steal_rows(state, planes, index, **widths)]
    p_state, p_planes = to_port("state", state), to_port("planes", planes)
    got = tf.pack_steal_rows_reference(p_state, p_planes,
                                       torch.from_numpy(index), *widths.values())
    for mine, theirs in zip(got, ref):
        assert mine.numpy().dtype == theirs.dtype \
            and np.array_equal(mine.numpy(), theirs)
    ref_state, ref_planes = jf._unpack_steal_rows(*ref, 3, **widths)
    rows_state, rows_planes = tf.unpack_steal_rows_reference(
        *got, 3, *widths.values())
    assert sorted(rows_state) == sorted(ref_state)
    assert sorted(rows_planes) == sorted(ref_planes)
    idx = torch.from_numpy(index).long()
    for rows, tree, theirs in ((rows_state, p_state, ref_state),
                               (rows_planes, p_planes, ref_planes)):
        for field, mine in rows.items():
            assert torch.equal(mine, getattr(tree, field)[idx]), field
            expected = np.asarray(theirs[field])
            if expected.dtype == np.uint32:
                expected = expected.view(np.int32)
            assert np.array_equal(mine.numpy(), expected), field


def _pool_fixture(n_lanes, n_shards, pool_rows, tops, running=None):
    """A lane batch and a sharded scheduler whose pools hold distinct
    recognizable rows; `running[d]` of block d's lanes RUNNING (all of
    them when None)."""
    state, planes = _lane_batch(n_lanes)
    if running is not None:
        status = np.full(n_lanes, jbatch.DEAD, dtype=np.int32)
        block = n_lanes // n_shards
        for d, count in enumerate(running):
            status[d * block:d * block + count] = jbatch.RUNNING
        state = state._replace(status=status)
    sched = jsym.new_scheduler(state, planes, pool_rows, pool_rows,
                               n_shards=n_shards)
    sched = sched._replace(
        stack_state=_filled(sched.stack_state, seed=21),
        stack_planes=_filled(sched.stack_planes, seed=42),
        stack_top=np.asarray(tops, dtype=np.int32))
    return np_tree(state), np_tree(sched)


STEAL_CASES = {
    # test_fleet_shard's forced imbalance: 4 rows in shard 1's segment
    "forced": (lambda: _pool_fixture(8, 2, 8, [0, 4]), 1, 4),
    # a gap of 1 under a threshold of 8
    "below_threshold": (lambda: _pool_fixture(8, 2, 8, [1, 2]), 8, 4),
    # three shards: 0 and 2 pair, the middle one stays as it is
    "d3_middle": (lambda: _pool_fixture(12, 3, 12, [0, 2, 4]), 1, 4),
    # loads 3, 3, 0, 0: the stable order pairs (2, 1) and (3, 0)
    "tied": (lambda: _pool_fixture(16, 4, 16, [3, 3, 0, 0],
                                   running=[0, 0, 0, 0]), 1, 4),
    # loads 3 and 8: half the gap is 2, the receiver has room for 1
    "short_room": (lambda: _pool_fixture(8, 2, 8, [3, 4],
                                         running=[0, 4]), 1, 4),
}


@pytest.mark.parametrize("case", sorted(STEAL_CASES))
def test_steal_pass_matches_jax(case):
    make, min_imbalance, max_rows = STEAL_CASES[case]
    state, sched = make()
    ref = jf._steal_compiled()(state, sched, min_imbalance=min_imbalance,
                               max_rows=max_rows)
    got = tf.steal_pass_reference(to_port("state", state),
                                  to_port("sched", sched), min_imbalance,
                                  max_rows)
    assert_same(ref, got)
    moved = int(got.steal_rows)
    assert moved == {"forced": 2, "below_threshold": 0, "d3_middle": 2,
                     "tied": 2, "short_room": 1}[case]
    if case == "d3_middle":
        assert got.stack_top.tolist() == [2, 2, 2]
        assert got.steals_sent[1] == 0 and got.steals_received[1] == 0


def test_steal_pass_mid_run_matches_jax(shard_trace):
    """The steal pass on a real mid-run state of the segmented step."""
    ref_trees, port_trees = shard_trace[2][3]
    state, sched = ref_trees[0], ref_trees[3]
    ref = jf._steal_compiled()(state, sched, min_imbalance=1, max_rows=4)
    got = tf.steal_pass_reference(port_trees[0],
                                  convert.clone(port_trees[3]), 1, 4)
    assert_same(ref, got)
    assert int(got.steal_rows) > 0


def test_steal_pass_refuses_one_shard():
    state, planes = _lane_batch(4)
    sched = tsym.new_scheduler(to_port("state", state),
                               to_port("planes", planes), 4, 4)
    with pytest.raises(ValueError):
        tf.steal_pass(to_port("state", state), sched, 1, 4)


# ---- seed placement -----------------------------------------------------------------

@pytest.mark.parametrize("n_seeds, owners", [
    (6, None), (5, [0, 2, 2, 1, 3]), (9, [1] * 9), (16, [3] * 16)],
    ids=["round_robin", "owners", "overflow", "full"])
def test_assign_seed_lanes_matches_jax(n_seeds, owners):
    frontier = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    frontier.n_shards = 4
    frontier._seed_owner_index = owners
    port = tf.DeviceFrontier(N_LANES, device="cpu", n_shards=4,
                             seed_owner_index=owners,
                             arena=to_port("arena", jarena.new_arena(64, 16)))
    assert port.assign_seed_lanes(n_seeds) \
        == frontier._assign_seed_lanes(n_seeds)
    one = tf.DeviceFrontier(N_LANES, device="cpu",
                            arena=to_port("arena", jarena.new_arena(64, 16)))
    assert one.assign_seed_lanes(n_seeds) == list(range(n_seeds))


# ---- the driver -------------------------------------------------------------------------

POOL_ROWS = 32


def test_sharded_hand_over_matches_jax(monkeypatch):
    """A budget of two chunks: live lanes and both pools' segment prefixes
    (vector tops) are packed into `deferred` as the JAX hand-over fetches
    them (its per-lane materialization replaced by the same deferral)."""
    code = assemble(dispatcher({"stress()": branchy_contract(7)}))
    monkeypatch.setenv("MYTHRIL_TPU_MAX_STEPS", str(2 * 64))
    port = tf.DeviceFrontier(N_LANES, device="cpu", n_shards=2,
                             telemetry=False, state_merge=False,
                             max_steps=2 * 64, steal_cadence=1,
                             steal_min_imbalance=1,
                             arena=to_port("arena", jarena.new_arena(64, 16)))
    state, planes = port.seed([(code, {}, False, 10_000_000, 0)])
    state_np = jbatch.StateBatch(**convert.to_numpy(state)._asdict())
    planes_np = jsym.SymPlanes(**convert.to_numpy(planes)._asdict())
    arena = jarena.new_arena(1 << 16, 1 << 12)
    row_bytes = row_bytes_of(state_np, planes_np)
    frontier = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    frontier.telemetry_enabled = frontier.state_merge = False
    frontier.arena = arena
    frontier.stack_bytes = frontier.esc_bytes = POOL_ROWS * row_bytes
    frontier.n_shards, frontier.steal_cadence = 2, 1
    frontier.steal_min_imbalance = 1
    monkeypatch.setattr(
        frontier, "_materialize_lanes",
        lambda state, planes, harena, lanes: frontier._defer_lanes(
            state, planes, lanes))
    frontier.run(state_np, planes_np)
    port.stack_bytes = port.esc_bytes = POOL_ROWS * row_bytes
    port.arena = to_port("arena", arena)
    port.run(state, planes)
    assert port.chunks == 2 and port.steal_rows > 0
    assert tf.deferred_digest(port.deferred) \
        == tf.deferred_digest(frontier.deferred)
    assert tf.mirror_digest(port.harena) == tf.mirror_digest(frontier.harena)
    assert sum(block[2] for block in port.deferred) > port.drained_rows
