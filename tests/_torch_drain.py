"""Shared helpers of the tests that hold the port's frontier drain loop
(mythril_tpu_torch/parallel/frontier.py) to the JAX `_Frontier`:
tests/test_torch_frontier.py, tests/test_torch_shard*.py,
tests/test_torch_observe_frontier.py, and the two files that recompute
chip_smoke.py's drain constants with JAX
(tests/test_torch_frontier_constants*.py, one file each half so that
`--dist loadfile` runs the halves on two workers)."""

import json

import numpy as np
import pytest

from _torch_parity import jax_static_tables
from bench import _mem_branchy_contract
from chip_smoke import branchy_contract
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import batch as jb
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import frontier as tf


@pytest.fixture(scope="module", autouse=True)
def unspent_time_budget():
    """The JAX driver stops at the host engine's global time budget, which
    an analysis test run earlier in this process may have left spent: run
    these tests with it disarmed, as a fresh process has it. (A module
    that imports this fixture gets it.)"""
    from mythril_tpu.core.time_handler import time_handler

    saved = (time_handler._start_time, time_handler._execution_time)
    time_handler.reset()
    yield
    time_handler._start_time, time_handler._execution_time = saved

def row_bytes_of(state, planes) -> int:
    return sum(int(np.dtype(leaf.dtype).itemsize) * int(np.prod(leaf.shape[1:]))
               for leaf in list(state) + list(planes))

def count_frozen(frontier):
    """Wrap the JAX frontier's frozen-lane deferral to count its lanes."""
    frozen = [0]
    defer = frontier._defer_lanes

    def counting(state, planes, lanes):
        frozen[0] += len(lanes)
        return defer(state, planes, lanes)

    frontier._defer_lanes = counting
    return frozen

def jax_tables(codes) -> dict:
    """`jax_static_tables(codes)` keyed as `static_tables` returns them."""
    tags, merge_table = jax_static_tables(codes)
    return dict(zip(tf.TABLE_KEYS, (*tags, *merge_table)))


def same_tables(got: dict, expected: dict) -> None:
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

def counting_drain(frontier, monkeypatch):
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


def check_sharded_constants(chip_smoke, codes, expected, owners, fleet_names,
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
    same_tables(tf.static_tables(codes), jax_tables(codes))
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
    frozen = count_frozen(frontier)
    counts, mstats = counting_drain(frontier, monkeypatch)
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

def check_drain_constants(which: str, monkeypatch) -> None:
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
    the tables of both codes. Recompute case `which` with JAX."""
    import chip_smoke

    if which == "fleet":
        names = list(chip_smoke.FLEET_RUN)
        bodies = [chip_smoke.FLEET_RUN[name] for name in names]
        codes = [assemble(dispatcher({"stress()": body})) for body in bodies]
        check_sharded_constants(chip_smoke, codes, chip_smoke.EXPECTED_FLEET,
                                 chip_smoke.FLEET_OWNERS, names, monkeypatch)
        return
    if which == "shard":
        code = assemble(dispatcher({"stress()": branchy_contract(
            chip_smoke.N_BRANCHES)}))
        check_sharded_constants(chip_smoke, [code], chip_smoke.EXPECTED_SHARD,
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
            * row_bytes_of(state, planes)
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
    frozen = count_frozen(frontier)
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
