"""The port's state merging (`merge_pass_reference`, the twin of kernel
K10) against the JAX package's `merge_pass`, exactly: every leaf of the
state, planes and arena (node ids included) and the stats vector.

Inputs: test_absint.py's both-arms-write diamond with and without its
window table; test_frontier_merge.py's diamonds; mid-run states of
`dispatcher(branchy(9))` and of `dispatcher(mem_branchy(8))` (bench.py's
memory diamonds, with the window table the JAX static analysis builds) at
16 lanes and 6 rounds; and arenas one or two nodes short, so a pair's
blend runs out of nodes mid-way and is cancelled."""

import numpy as np
import pytest

from _torch_parity import (assert_same, jax_static_tables, np_tree,
                           seed_frontier, to_port)
from bench import _mem_branchy_contract
from chip_smoke import branchy_contract
from mythril_tpu.frontends.asm import assemble, dispatcher
from mythril_tpu.parallel import arena as jarena
from mythril_tpu.parallel import batch as jbatch
from mythril_tpu.parallel import frontier as jf
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.parallel import symstep as tsym
from test_absint import DIAMOND_BOTHWRITE

#: test_frontier_merge.py's diamonds: the arms push 5 and 7 and reconverge
#: at pc 15; the second's fall arm also writes memory before the join (23)
DIAMOND = bytes.fromhex(
    "600035" "600b57" "6007600f56" "5b6005" "5b" "5b600f56")
DIAMOND_MEMWRITE = bytes.fromhex(
    "600035" "601057" "6005" "6007600053" "601756" "5b6005" "5b5b5b5b"
    "5b601756")
STOP_ONLY = bytes.fromhex("00")
N_LANES = 16


def test_constants_match_jax():
    assert tsym.MERGE_DEPTH_LABELS == jsym.MERGE_DEPTH_LABELS
    assert tsym.MERGE_BLOCKED_LABELS == jsym.MERGE_BLOCKED_LABELS
    assert tsym.MERGE_STATS_FIXED == jsym.MERGE_STATS_FIXED
    assert (tsym._H_PRIME, tsym._H_MASK) == (jsym._H_PRIME, jsym._H_MASK)


def test_merge_fold_widens_uint32_with_zeros():
    """A uint32 leaf with its top bit set hashes as JAX hashes it: widened
    with zeros, although the port holds it as int32."""
    rng = np.random.default_rng(5)
    leaf = rng.integers(0, 1 << 32, (4, 3, 16), dtype=np.uint64) \
        .astype(np.uint32)
    acc = rng.integers(-(1 << 62), 1 << 62, 4)
    ref = np.asarray(jsym._merge_fold(acc, leaf))
    import torch

    got = tsym._merge_fold(torch.from_numpy(acc),
                           torch.from_numpy(leaf.view(np.int32)),
                           unsigned=True).numpy()
    assert np.array_equal(got, ref)
    signed = tsym._merge_fold(torch.from_numpy(acc),
                              torch.from_numpy(leaf.view(np.int32))).numpy()
    assert not np.array_equal(signed, ref)


def _pair_run(code, n_steps):
    """One diamond lane and a STOP lane whose death the fork claims, as
    test_frontier_merge.py and test_absint.py run them."""
    specs = [jbatch.LaneSpec(code, gas_limit=2 ** 40),
             jbatch.LaneSpec(STOP_ONLY, gas_limit=2 ** 40)]
    state = jbatch.build_batch(specs, stack_slots=16, memory_bytes=128,
                               calldata_bytes=64, retdata_bytes=32,
                               storage_slots=8, tstore_slots=2)
    planes = jsym.SymPlanes.empty(2, 16, 128, 8, max_conds=8)
    arena = jarena.new_arena(capacity=1 << 10, const_capacity=1 << 6)
    sched = jsym.new_scheduler(state, planes, 4, 4)
    state, planes, arena, _ = jsym.run_chunk(state, planes, arena, sched,
                                             n_steps)
    return np_tree((state, planes, arena))


def _shrink(arena, spare):
    """The arena cut to `spare` free nodes."""
    cap = int(arena.n) + spare
    return arena._replace(**{field: getattr(arena, field)[:cap]
                             for field in ("op", "a", "b", "c", "imm", "imm2", "cls")})


def _compare(state, planes, arena, merge_pcs, mem_pcs=None, mem_words=None,
             n_rounds=6):
    """Both merge passes from the same input; returns JAX's stats."""
    port = [to_port(kind, tree) for kind, tree in
            zip(("state", "planes", "arena"), (state, planes, arena))]
    ref = np_tree(jf._merge_compiled()(
        state, planes, arena, merge_pcs,
        np.zeros(0, np.int32) if mem_pcs is None else mem_pcs,
        np.zeros((0, 1), np.int32) if mem_words is None else mem_words,
        n_rounds=n_rounds))
    got = tsym.merge_pass(*port, merge_pcs, mem_pcs, mem_words,
                          n_rounds=n_rounds)
    for kind, jax_tree, port_tree in zip(("state", "planes", "arena"),
                                         ref[:3], got[:3]):
        assert_same(jax_tree, port_tree, f"{kind}.")
    stats = got[3].numpy()
    assert stats.dtype == ref[3].dtype and np.array_equal(stats, ref[3])
    return ref


DIAMONDS = {
    "diamond": (DIAMOND, 10, [15], None, None),
    "memwrite": (DIAMOND_MEMWRITE, 10, [23], None, None),
    "bothwrite": (DIAMOND_BOTHWRITE, 13, [25], None, None),
    "bothwrite_windows": (DIAMOND_BOTHWRITE, 13, [25], [25], [[0]]),
}


@pytest.mark.parametrize("name", sorted(DIAMONDS))
def test_diamond_merge_matches_jax(name):
    code, steps, merge_pcs, mem_pcs, mem_words = DIAMONDS[name]
    state, planes, arena = _pair_run(code, steps)
    to_i32 = (lambda v: None if v is None else np.asarray(v, np.int32))
    stats = _compare(state, planes, arena, to_i32(merge_pcs), to_i32(mem_pcs),
                     to_i32(mem_words), n_rounds=2)[3]
    expect = {"diamond": (1, 0, 0), "memwrite": (0, 0, 0),
              "bothwrite": (0, 0, 1), "bothwrite_windows": (1, 1, 0)}[name]
    assert (stats[0], stats[2], stats[3]) == expect


@pytest.mark.parametrize("name,spare", [("diamond", 1), ("diamond", 2),
                                        ("bothwrite_windows", 1),
                                        ("bothwrite_windows", 2)])
def test_overflow_mid_blend_cancels_the_pair(name, spare):
    """The arena runs out inside the pair's blend: the pair stays unmerged
    and the nodes already allocated stay allocated, as in JAX."""
    code, steps, merge_pcs, mem_pcs, mem_words = DIAMONDS[name]
    state, planes, arena = _pair_run(code, steps)
    to_i32 = (lambda v: None if v is None else np.asarray(v, np.int32))
    ref = _compare(state, planes, _shrink(arena, spare), to_i32(merge_pcs),
                   to_i32(mem_pcs), to_i32(mem_words), n_rounds=2)
    assert int(ref[3][0]) == 0 and int(ref[2].n) > int(arena.n)


def _mid_run(body, with_tables, n_chunks=6, chunk=16):
    """JAX run_chunk of 16 lanes with a merge pass after every chunk; each
    pass is compared with the port's from the same input. Returns the
    summed stats."""
    code = assemble(dispatcher({"stress()": body}))
    state, planes, arena = seed_frontier([code], N_LANES, max_conds=16,
                                         arena_capacity=1 << 14,
                                         const_capacity=1 << 12)
    sched = jsym.new_scheduler(state, planes, 32, 32)
    (_, _), (merge_pcs, _, mem_pcs, mem_words) = jax_static_tables([code])
    if not with_tables:
        mem_pcs = mem_words = None
    total = None
    for _ in range(n_chunks):
        state, planes, arena, sched = jsym.run_chunk(state, planes, arena,
                                                     sched, chunk)
        state, planes, arena = np_tree((state, planes, arena))
        state, planes, arena, stats = _compare(state, planes, arena,
                                               merge_pcs, mem_pcs, mem_words)
        total = stats if total is None else total + stats
        sched = sched._replace(esc_count=np.zeros((), np.int32))
    return total


def test_branchy_mid_run_matches_jax():
    stats = _mid_run(branchy_contract(9), with_tables=False)
    assert stats[0] > 0 and stats[1] > 0  # siblings merge, stack slots blend


@pytest.mark.parametrize("with_tables", [True, False])
def test_mem_branchy_mid_run_matches_jax(with_tables):
    stats = _mid_run(_mem_branchy_contract(8), with_tables)
    if with_tables:
        assert stats[0] > 0 and stats[2] > 0  # widened rounds blend memory
    else:
        assert stats[0] == 0 and stats[3:8].sum() > 0  # blocked, counted
