"""The port's sharded driver against the JAX package's, exactly:
`DeviceFrontier(16, device="cpu", n_shards=2, steal_cadence=1,
steal_min_imbalance=1)` against JAX `_Frontier(laser_evm=None,
n_lanes=16)` with the same settings set on the instance, with telemetry
and merging off and on: deferred rows, mirror, counters, steal counters
and digests, and the steals that spread block 0's tree to block 1.

These drives were tests/test_torch_shard.py's; they are a file of their
own so that `--dist loadfile` gives them a worker of their own."""

import numpy as np
import pytest

# unspent_time_budget: autouse, the JAX driver's time budget disarmed
from _torch_drain import row_bytes_of, unspent_time_budget  # noqa: F401
from _torch_parity import jax_static_tables, to_port
from chip_smoke import branchy_contract
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import arena as jarena
from mythril_tpu.parallel import batch as jbatch
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import frontier as tf
from test_torch_shard import N_LANES, PLANES, POOL_ROWS


@pytest.fixture(scope="module", params=["off", "default"])
def shard_drive(request):
    """Both drivers, 2 shards, a steal pass every chunk at threshold 1,
    from one branchy(7) seed in block 0 and a planes seed in block 1."""
    code = assemble(dispatcher({"stress()": branchy_contract(7)}))
    port = tf.DeviceFrontier(N_LANES, device="cpu", n_shards=2,
                             seed_owner_index=[0, 1],
                             arena=to_port("arena", jarena.new_arena(64, 16)))
    state, planes = port.seed([(code, {}, False, 10_000_000, 0),
                               (PLANES, {}, False, 10_000_000, 0)])
    assert int(state.status[8]) == jbatch.RUNNING
    state_np = jbatch.StateBatch(**convert.to_numpy(state)._asdict())
    planes_np = jsym.SymPlanes(**convert.to_numpy(planes)._asdict())
    arena = jarena.new_arena(1 << 16, 1 << 12)
    row_bytes = row_bytes_of(state_np, planes_np)
    on = request.param == "default"
    frontier = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    frontier.telemetry_enabled = frontier.state_merge = on
    frontier.arena = arena
    frontier.stack_bytes = frontier.esc_bytes = POOL_ROWS * row_bytes
    frontier.n_shards, frontier.steal_cadence = 2, 1
    frontier.steal_min_imbalance = 1
    kwargs = {"telemetry": on, "state_merge": on}
    if on:
        tags, merge_table = jax_static_tables([code, PLANES])
        frontier._collect_tag_pcs = lambda: tags
        frontier._merge_pc_table = lambda: merge_table
        frontier._collect_fleet_slots = lambda: ([0, 1], ["a", "b"])
        merge_pcs, merge_names, mem_pcs, mem_words = merge_table
        kwargs.update(tag_pcs=tags[0], tag_names=tags[1],
                      merge_pcs=merge_pcs, merge_names=merge_names,
                      mem_pcs=mem_pcs, mem_words=mem_words,
                      fleet_slots=[0, 1], fleet_names=["a", "b"])
    shards = []
    publish = frontier._publish_shard

    def recording(words, status):
        shards.append(np.asarray(words))
        return publish(words, status)

    frontier._publish_shard = recording
    frontier.run(state_np, planes_np)
    port = tf.DeviceFrontier(N_LANES, device="cpu", n_shards=2,
                             steal_cadence=1, steal_min_imbalance=1,
                             stack_bytes=POOL_ROWS * row_bytes,
                             esc_bytes=POOL_ROWS * row_bytes,
                             arena=to_port("arena", arena), **kwargs)
    port.run(state, planes)
    return request.param, frontier, shards, port


def test_sharded_driver_matches_jax(shard_drive):
    _, frontier, shards, port = shard_drive
    assert len(port.deferred) == len(frontier.deferred)
    assert tf.deferred_digest(port.deferred) \
        == tf.deferred_digest(frontier.deferred)
    assert tf.mirror_digest(port.harena) == tf.mirror_digest(frontier.harena)
    for counter in ("lane_steps", "forks", "stack_pushes", "stack_pops",
                    "spilled", "reseeded", "merges"):
        assert getattr(port, counter) == getattr(frontier, counter), counter
    assert port.steal_passes == frontier._steal_passes
    sent, recv, moved = frontier._shard_steals
    assert port.steals_sent.tolist() == sent.tolist()
    assert port.steals_received.tolist() == recv.tolist()
    assert port.steal_rows == moved
    assert np.array_equal(port.shard_tops, frontier._shard_tops)
    if frontier.telemetry_enabled:
        assert np.array_equal(port.tel_words, frontier._tel_prev)


def test_sharded_driver_steals(shard_drive):
    """Block 0's branchy tree spreads to block 1 only by stealing."""
    name, _, shards, port = shard_drive
    assert port.steal_rows > 0 and port.steals_received[1] > 0
    assert port.chunks == len(shards) > 1
    # every path ends in one deferred row; a merge retires one
    assert sum(block[2] for block in port.deferred) \
        == port.forks + 2 - port.merges
    if name == "default":
        assert port.fleet_occupancy.sum() == port.lane_steps
