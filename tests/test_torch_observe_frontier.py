"""The port's drain loop publishes what the JAX frontier publishes.

`DeviceFrontier(16, device="cpu").run` and JAX `_Frontier(laser_evm=None,
n_lanes=16).run` drive the same seeds (tests/test_torch_frontier.py's
default configuration: telemetry and merging on, 8-step chunks, the JAX
static analysis's tables handed to both; tests/test_torch_shard.py's
sharded drive: 2 shards, a steal pass every chunk, two fleet slots; and a
drive cut at a two-chunk step budget, whose rest is handed over), each
with its own registry reset and its tracer recording. Then:

- each snapshot's deterministic part is equal (tests/_torch_observe.py
  names what is left out and why);
- the ordered counter-track samples (`frontier.lanes`, `arena`,
  `memory`, `ops`, `causes`, `lifecycle`, `tags`, `fleet`, `merges`,
  `shard`), names and series, are equal;
- the multisets of span and instant names are equal."""

import numpy as np
import pytest
import torch

from _torch_drain import row_bytes_of
from _torch_observe import (counter_samples, deterministic, observed,
                            span_names)
from _torch_parity import jax_static_tables, to_port
from bench import _mem_branchy_contract
from chip_smoke import PLANES_SOURCE, branchy_contract
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import arena as jarena
from mythril_tpu.parallel import batch as jbatch
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import frontier as tf
from test_torch_frontier import DEFAULT_CHUNK, N_LANES, POOL_ROWS, _seed

PLANES = assemble(dispatcher({"planes()": PLANES_SOURCE}))


@pytest.fixture(scope="module", autouse=True)
def _unspent_time_budget():
    """The JAX driver stops at the host engine's global time budget, which
    an earlier test in this process may have spent."""
    from mythril_tpu.core.time_handler import time_handler

    saved = (time_handler._start_time, time_handler._execution_time)
    time_handler.reset()
    yield
    time_handler._start_time, time_handler._execution_time = saved


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _default_pair(body: str, patch, max_steps: int = tf.MAX_STEPS):
    """(JAX frontier, its drive, the port's drive) of
    tests/test_torch_frontier.py's default configuration on
    dispatcher({"stress()": body}), with a step budget."""
    code = assemble(dispatcher({"stress()": body}))
    state, planes, arena = _seed([code])
    row_bytes = row_bytes_of(state, planes)
    tags, merge_table = jax_static_tables([code])
    frontier = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    frontier.arena = arena
    frontier.stack_bytes = frontier.esc_bytes = POOL_ROWS * row_bytes
    frontier._collect_tag_pcs = lambda: tags
    frontier._merge_pc_table = lambda: merge_table
    merge_pcs, merge_names, mem_pcs, mem_words = merge_table
    port = tf.DeviceFrontier(
        N_LANES, device="cpu", stack_bytes=POOL_ROWS * row_bytes,
        esc_bytes=POOL_ROWS * row_bytes, arena=to_port("arena", arena),
        chunk=DEFAULT_CHUNK, tag_pcs=tags[0], tag_names=tags[1],
        merge_pcs=merge_pcs, merge_names=merge_names, mem_pcs=mem_pcs,
        mem_words=mem_words, max_steps=max_steps)
    patch.setenv("MYTHRIL_TPU_CHUNK", str(DEFAULT_CHUNK))
    patch.setenv("MYTHRIL_TPU_MAX_STEPS", str(max_steps))
    return (frontier, lambda: frontier.run(state, planes),
            lambda: port.run(to_port("state", state),
                             to_port("planes", planes)))


def _shard_pair(patch):
    """(JAX frontier, its drive, the port's drive) of
    tests/test_torch_shard.py's sharded
    default drive: branchy(7) in block 0, the planes contract in block 1,
    a steal pass every chunk at threshold 1, fleet slots "a" and "b"."""
    code = assemble(dispatcher({"stress()": branchy_contract(7)}))
    port = tf.DeviceFrontier(N_LANES, device="cpu", n_shards=2,
                             seed_owner_index=[0, 1],
                             arena=to_port("arena", jarena.new_arena(64, 16)))
    state, planes = port.seed([(code, {}, False, 10_000_000, 0),
                               (PLANES, {}, False, 10_000_000, 0)])
    state_np = jbatch.StateBatch(**convert.to_numpy(state)._asdict())
    planes_np = jsym.SymPlanes(**convert.to_numpy(planes)._asdict())
    arena = jarena.new_arena(1 << 16, 1 << 12)
    row_bytes = row_bytes_of(state_np, planes_np)
    frontier = jf._Frontier(laser_evm=None, n_lanes=N_LANES)
    frontier.arena = arena
    frontier.stack_bytes = frontier.esc_bytes = POOL_ROWS * row_bytes
    frontier.n_shards, frontier.steal_cadence = 2, 1
    frontier.steal_min_imbalance = 1
    tags, merge_table = jax_static_tables([code, PLANES])
    frontier._collect_tag_pcs = lambda: tags
    frontier._merge_pc_table = lambda: merge_table
    frontier._collect_fleet_slots = lambda: ([0, 1], ["a", "b"])
    merge_pcs, merge_names, mem_pcs, mem_words = merge_table
    port = tf.DeviceFrontier(
        N_LANES, device="cpu", n_shards=2, steal_cadence=1,
        steal_min_imbalance=1, stack_bytes=POOL_ROWS * row_bytes,
        esc_bytes=POOL_ROWS * row_bytes, arena=to_port("arena", arena),
        tag_pcs=tags[0], tag_names=tags[1], merge_pcs=merge_pcs,
        merge_names=merge_names, mem_pcs=mem_pcs, mem_words=mem_words,
        fleet_slots=[0, 1], fleet_names=["a", "b"])
    return (frontier, lambda: frontier.run(state_np, planes_np),
            lambda: port.run(state, planes))


def _hand_over_pair(patch):
    """The mem_branchy(8) default configuration cut at a two-chunk step
    budget: the rest is handed over (the JAX side's per-lane
    materialization replaced by the port's deferral)."""
    drives = _default_pair(_mem_branchy_contract(8), patch,
                           max_steps=2 * DEFAULT_CHUNK)
    frontier = drives[0]
    patch.setattr(frontier, "_materialize_lanes",
                  lambda state, planes, harena, lanes:
                  frontier._defer_lanes(state, planes, lanes))
    return drives


#: mem_branchy(8) first: the hand-over drive reuses its compiled programs
CASES = {
    "mem_branchy8": lambda patch: _default_pair(_mem_branchy_contract(8),
                                                patch),
    "hand_over": _hand_over_pair,
    "sharded": _shard_pair,
}


@pytest.fixture(scope="module", params=list(CASES))
def drives(request, tmp_path_factory):
    """{"jax": ..., "port": ...}: what each side's drive left in its
    registry and its trace."""
    directory = str(tmp_path_factory.mktemp("observe-" + request.param))
    with pytest.MonkeyPatch.context() as patch:
        _, jax_run, port_run = CASES[request.param](patch)
        return request.param, {
            "jax": observed("jax", jax_run, directory),
            "port": observed("port", port_run, directory)}


def test_snapshots_are_equal(drives):
    name, got = drives
    jax_snapshot = deterministic(got["jax"]["snapshot"])
    port_snapshot = deterministic(got["port"]["snapshot"])
    assert port_snapshot == jax_snapshot
    assert port_snapshot["frontier.chunks"] > 1
    assert port_snapshot["frontier.telemetry.executed"] > 0
    if name == "sharded":
        assert port_snapshot["frontier.shard.steal_rows"] > 0
        assert set(port_snapshot["frontier.fleet.lane_steps"]) == {"a", "b"}
    if name == "mem_branchy8":
        assert port_snapshot["frontier.merge.events"] > 0
        assert port_snapshot["absint.merge.mem_blends"] > 0
    if name == "hand_over":
        assert port_snapshot["frontier.chunks"] == 2


def test_counter_tracks_are_equal(drives):
    name, got = drives
    samples = counter_samples(got["port"]["events"])
    assert samples == counter_samples(got["jax"]["events"])
    tracks = {track for track, _ in samples}
    assert {"frontier.lanes", "frontier.arena", "frontier.memory",
            "frontier.ops", "frontier.causes",
            "frontier.lifecycle"} <= tracks
    if name == "sharded":
        assert {"frontier.shard", "frontier.fleet"} <= tracks
    if name == "mem_branchy8":
        assert {"frontier.tags", "frontier.merges"} <= tracks


def test_span_names_are_equal(drives):
    name, got = drives
    names = span_names(got["port"]["events"])
    assert names == span_names(got["jax"]["events"])
    assert names[("X", "frontier.chunk")] > 1
    assert names[("X", "frontier.sync")] == names[("X", "frontier.chunk")]
    if name == "sharded":
        assert names[("X", "frontier.steal")] > 0
    if name == "hand_over":
        assert names[("i", "frontier.hand_over")] == 1
