"""The port at 2048 lanes, past the 1024 that K4 and K10 once scanned in
one block, and K4's cached step plan, checked without a card.

* the twins equal JAX at 2048 lanes: `run_chunk_reference` for a chunk and
  `merge_pass_reference` for one pass, at a narrow geometry, on lanes
  whose 32-lane blocks each hold a forking seed, spinning fillers and three
  DEAD lanes, so forks claim, push and spill; and no index write of theirs
  there puts two values in one cell but in a drop slot nothing reads;
* the kernel sources, compiled by g++ under tests/_host_shim.h, equal the
  twins at 2048 lanes: K4 with K3's four allocations folded in at D = 1
  (a segment spanning 32 blocks), D = 2 with telemetry, and D = 64 (two
  segments sharing a block); K10's pairing above 1024 lanes (a launch per
  stage of the sort) on keys with many ties;
* the cached parameter block gives what a rebuilt one gives, and a tensor
  rebound to new storage changes the key."""

import numpy as np
import pytest
import torch

from _torch_parity import assert_same, jax_static_tables, to_port
from mythril_tpu.frontends.asm import assemble
from mythril_tpu.parallel import symstep as jsym
from mythril_tpu_torch.kernels import layout, ops
from mythril_tpu_torch.parallel import convert
from mythril_tpu_torch.parallel import frontier as tf
from mythril_tpu_torch.parallel import symstep as tsym
from test_torch_kernels import _same, host_kernels, on_host  # noqa: F401
from test_torch_shard import BRANCHY5, KILL, KINDS, PLANES, seed_lanes

WIDE = 2048
STEPS = 24
POOL_ROWS, ESC_ROWS = 256, 1024
#: a concrete loop that never ends: it keeps a lane busy
SPIN = assemble("JUMPDEST\nPUSH1 0x00\nJUMP")
#: a loop that forks on a calldata word each time round, both sides looping
FORKER = assemble("JUMPDEST\nPUSH1 0x00\nCALLDATALOAD\nPUSH1 0x00\nJUMPI\n"
                  "PUSH1 0x00\nJUMP")


def wide_lanes():
    """JAX lanes: each 32-lane block holds a seed (the forking loop, or in
    turn branchy(5), the planes contract or KILLBILLY) among its first
    four lanes, three DEAD lanes and 28 spinning lanes."""
    placed = {}
    for block in range(WIDE // 32):
        base = 32 * block
        placed[base + block % 4] = (FORKER, BRANCHY5, FORKER, PLANES, FORKER,
                                    KILL)[block % 6]
        for lane in range(base + 4, base + 32):
            placed[lane] = SPIN
    return seed_lanes(placed, n_lanes=WIDE, base_sym=[2 + 32 * 5],
                      arena_capacity=1 << 16)


def _jax_chunk():
    state, planes, arena = wide_lanes()
    sched = jsym.new_scheduler(state, planes, POOL_ROWS, ESC_ROWS)
    return (state, planes, arena, sched), jsym.run_chunk(state, planes,
                                                         arena, sched, STEPS)


def test_wide_twins_match_jax():
    """`run_chunk_reference`, then `merge_pass_reference` (strict and
    widened rounds, the codes' tables) at 2048 lanes, against JAX."""
    before, after = _jax_chunk()
    tree = [to_port(k, t) for k, t in zip(KINDS, before)]
    tree = list(tsym.run_chunk_reference(*tree, STEPS))
    for kind, ref, got in zip(KINDS, after, tree):
        assert_same(ref, got, f"{kind}.")
    sched = tree[3]
    assert int(sched.pushes) and int(sched.forks) > int(sched.pushes)

    _, (merge_pcs, _, mem_pcs, mem_words) = jax_static_tables(
        [BRANCHY5, PLANES, KILL])
    state, planes, arena, _ = after
    ref = jsym.merge_pass(state, planes, arena, merge_pcs, mem_pcs,
                          mem_words, 2)
    got = tsym.merge_pass_reference(*tree[:3], merge_pcs, mem_pcs, mem_words,
                                    n_rounds=2)
    for kind, want, mine in zip(KINDS, ref[:3], got[:3]):
        assert_same(want, mine, f"merge {kind}.")
    assert np.array_equal(np.asarray(ref[3]), got[3].numpy())


def test_wide_twins_write_no_cell_twice():
    """No index write of `run_chunk_reference` or `merge_pass_reference`
    on the wide lanes puts two different values in one cell, but in the
    drop slots that nothing reads: the twins' results cannot depend on the
    order of a write's CPU threads."""
    from _torch_writes import conflicting_writes

    state, planes, arena = wide_lanes()
    sched = jsym.new_scheduler(state, planes, POOL_ROWS, ESC_ROWS)
    tree = [to_port(k, t) for k, t in zip(KINDS, (state, planes, arena,
                                                  sched))]
    _, (merge_pcs, _, mem_pcs, mem_words) = jax_static_tables(
        [BRANCHY5, PLANES, KILL])
    with conflicting_writes() as found:
        tree = list(tsym.run_chunk_reference(*tree, STEPS))
        tsym.merge_pass_reference(*tree[:3], merge_pcs, mem_pcs, mem_words,
                                  n_rounds=2)
    assert found["writes"] > 500
    assert all(drop for _, _, drop, _ in found["conflicts"]), \
        found["conflicts"]
    assert {caller for caller, _, _, _ in found["conflicts"]} <= {
        "parallel/symstep.py:sym_step_reference",
        "parallel/lockstep.py:mem_write"}


@pytest.mark.parametrize("n_shards, telemetry, lanes_per_block, group",
                         [(1, False, 64, 1), (2, True, 16, 2),
                          (64, False, 64, 1)], ids=["d1", "d2-tel", "d64"])
def test_host_wide_step_matches_twin(on_host, n_shards, telemetry,
                                     lanes_per_block, group):
    """K4 (K3 folded in) at 2048 lanes against the twin after every chunk
    of 12 steps, the escape counts zeroed between chunks as the drain does:
    every leaf, the arena and the scheduler."""
    state, planes, arena = wide_lanes()
    tel = jsym.new_telemetry([5, 13, 0x1B], fleet_slots=[0, 1, 1],
                             n_fleet=2) if telemetry else None
    sched = jsym.new_scheduler(state, planes, POOL_ROWS, ESC_ROWS,
                               telemetry=tel, n_shards=n_shards)
    plain = [to_port(k, t) for k, t in zip(KINDS, (state, planes, arena,
                                                   sched))]
    kernel = [convert.clone(t) for t in plain]
    for chunk in range(STEPS // 12):
        plain = list(tsym.run_chunk_reference(*plain, 12))
        for _ in range(12):
            kernel = list(ops.sym_step(*kernel, lanes_per_block=lanes_per_block,
                                       group=group))
        for kind, got, ref in zip(KINDS, kernel, plain):
            _same(got, ref, f"chunk {chunk} {kind}")
        tf.reset_esc_reference(plain[3])
        tf.reset_esc_reference(kernel[3])
    assert int(plain[3].pushes) > 0 and int(plain[3].pops) >= 0
    assert int(plain[2].n) > 1


def test_host_wide_merge_pairs_match_twin(on_host):
    """K10's pairing above 1024 lanes (keys, a launch per stage of the
    bitonic network over 4096 entries, pairs) against the twin's stable
    argsort and roll, on 2050 lanes whose keys tie in large groups."""
    rng = np.random.default_rng(11)
    n = 2050
    state = tsym.StateBatch(*[leaf[:1].expand((n,) + leaf.shape[1:]).contiguous()
                              for leaf in to_port("state", wide_lanes()[0])])
    planes = tsym.SymPlanes.empty(n, state.stack.shape[1],
                                  state.memory.shape[1],
                                  state.storage_keys.shape[1], 4, device="cpu")
    planes.cond_count.copy_(torch.from_numpy(rng.integers(0, 3, n)
                                             .astype(np.int32)))
    templates = rng.choice([-3, -2, 0, 2, 3], (8, 4)).astype(np.int32)
    planes.conds.copy_(torch.from_numpy(templates[rng.integers(0, 8, n)]))
    state.status.copy_(torch.from_numpy(rng.choice(
        [tsym.RUNNING] * 6 + [tsym.DEAD], n).astype(np.int32)))
    empty = torch.zeros(0, dtype=torch.int32)
    values, tensors = ops.merge_block(state, planes, empty, empty,
                                      torch.zeros((0, 1), dtype=torch.int32))
    static_h = tsym._merge_hash(state, planes, tsym.MERGE_WEAK_LEAVES
                                + tsym.MERGE_MEM_LEAVES)
    tensors["hashes"][1].copy_(static_h)
    cc, _, last, conds_abs, eligible = tsym._merge_keys(state, planes)
    h = tsym._merge_fold(static_h, conds_abs) * tsym._H_PRIME + cc
    key = torch.where(eligible, ((h & tsym._H_MASK) << 1)
                      | (last > 0).to(torch.int64), tsym._H_SENTINEL)
    assert len(torch.unique(key)) < n // 4
    for shift in (0, 1):
        values[layout.K10_MODE] = 0
        values[layout.K10_SHIFT] = shift
        ops._launch("mtpu_merge_pair", values)
        fi, ti = tsym._pairs(key, shift)
        assert torch.equal(tensors["fi"], fi.to(torch.int32))
        assert torch.equal(tensors["ti"], ti.to(torch.int32))
        assert torch.equal(tensors["eligible"], eligible)


def test_host_step_plan_cache(on_host):
    """The cached step plan gives what a plan rebuilt every step gives;
    rebinding a leaf to new storage changes the key, and the new plan
    steps the rebound tensors."""
    from test_torch_symstep import CODES as codes
    from _torch_parity import seed_frontier

    state, planes, arena = seed_frontier(codes, 8, base_sym=[0])
    sched = jsym.new_scheduler(state, planes, 4, 3)
    cached = [to_port(k, t) for k, t in zip(KINDS, (state, planes, arena,
                                                    sched))]
    rebuilt = [convert.clone(t) for t in cached]
    key = ops.step_key(*cached)
    for _ in range(24):
        cached = list(ops.sym_step(*cached))
        ops._PLANS.clear()
        rebuilt = list(ops.sym_step(*rebuilt))
    for kind, got, ref in zip(KINDS, cached, rebuilt):
        _same(got, ref, kind)
    assert ops.step_key(*cached) == key
    plan = ops.step_plan(*cached)
    assert ops.step_plan(*cached) is plan
    moved = cached[1]._replace(mem_sym=cached[1].mem_sym.clone())
    assert ops.step_key(cached[0], moved, *cached[2:]) != key
    assert ops.step_plan(cached[0], moved, *cached[2:]) is not plan
    plain = [convert.clone(t) for t in (cached[0], moved, *cached[2:])]
    stepped = ops.sym_step(cached[0], moved, *cached[2:])
    for kind, got, ref in zip(KINDS, stepped,
                              tsym.sym_step_reference(*plain)):
        _same(got, ref, f"rebound {kind}")
