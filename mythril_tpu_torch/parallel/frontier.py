"""The frontier's drain loop, device half (port of
mythril_tpu/parallel/frontier.py:66-390, 706-747, 914-1014, 1068-1363,
1481-1531, 1616-1848, 2378-2435).

`DeviceFrontier.run` loops `symstep.run_chunk` and, between chunks, does what
the JAX driver does with the device's output:

  1. reads ONE packed summary vector (scheduler scalars, escape-row maxima,
     lane status, fork condition, context id) — the chunk's only blocking
     read besides what a drain needs;
  2. packs lanes frozen ESCAPED (escape buffer full) off to the deferred
     queue and frees them;
  3. spills half the waiting forkers to the host overflow tier when the
     frontier deadlocks with the sibling stack full;
  4. bulk-drains the escape buffer into packed host rows and mirrors the
     new arena rows, both copied to the host while the next chunk runs;
  5. reseeds host overflow rows into DEAD lanes once the stack is empty;
  6. decodes the telemetry words at the summary's end into per-chunk
     deltas, and runs a merge pass (`symstep.merge_pass`) when the merge
     tags' occupancy or the chunk cadence says so.

With `n_shards` D > 1 the lane axis and both scheduler pools split into D
logical shards (`symstep.new_scheduler(n_shards=D)`): seeds land in the
block of their owner (`assign_seed_lanes`), a steal pass (`steal_pass`)
moves pending rows from the richest segments to the poorest every
`steal_cadence` chunks without a host read, the summary carries a shard
block (per-shard tops, escape counts and steal counters) that the host
peels off first, and drains read the segments' used prefixes.

The device programs between chunks are kernels on CUDA tensors and plain
PyTorch twins (`*_reference`) on CPU tensors:

  K5 `summary`, `summary_read`          kernels/frontier_summary.cu
  K6 `row_maxima`, `pack_rows`, `reset_esc`  kernels/pack_rows.cu
  K7 `gather_rows(_flat)`, `scatter_rows`  kernels/gather_rows.cu
  K8 `arena.fetch_delta`                kernels/arena_delta.cu
  K10 `symstep.merge_pass`              kernels/merge_pass.cu
  K12 `steal_pass`                      kernels/steal_pass.cu

What the host does with the drained rows (materializing GlobalStates of
the port's host engine, cold-SLOAD fault-ins) is the single-contract
driver's, which is not ported (ROADMAP A 7): drained rows wait in
`deferred` as [rows_state, rows_planes, count, cursor] blocks, and a
cold-SLOAD pause goes to a caller-given `service_cold` hook.
`LoopHintAnnotation` rides on such materialized states. The
static tables that tag merge points and bound the widened memory merge
are built by the port's static analysis (`static_tables`, from
`staticanalysis/` through `smt/solver/cfa_screen.py` and
`analysis/module_screen.py`) when `seed` sees the codes, unless the caller
hands them in. The fleet driver (per-member budgets, deadline drains) and
checkpoints are not ported (ROADMAP A 11, 7): a caller hands in the
seeds' owners and the fleet slots."""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..analysis import module_screen
from ..core.state.annotation import StateAnnotation
from ..frontends.disassembler import Disassembly
from ..smt.solver import cfa_screen
from . import arena as A
from . import symstep, words
from .batch import (DEAD, ESCAPED, FORKING, RUNNING, U32_FIELDS, LaneSpec,
                    StateBatch, build_batch, next_pow2, row_layout,
                    row_views, shard_count)
from .symstep import SymPlanes

I32 = torch.int32
I64 = torch.int64

#: stop the device phase when the arena has less head-room than this
ARENA_HEADROOM = 16_384
#: fused steps between summaries
CHUNK = 64
#: hard step budget per transaction phase
MAX_STEPS = 4_096
#: device lanes (seeds + fork capacity)
DEFAULT_LANES = 128
#: per-lane path-constraint capacity (conds plane)
MAX_CONDS = 64
#: telemetry tag slots (frontier.py:751)
TAG_SLOTS = 32
#: merge-attribution and window-table rows (frontier.py:814)
MERGE_PC_SLOTS = 64
#: pairing rounds per merge pass (frontier.py:403)
MERGE_ROUNDS = 6
#: merge-tag lane visits per chunk that trigger a pass
#: (MYTHRIL_TPU_MERGE_MIN_LANES)
MERGE_MIN_LANES = 2
#: chunks between steal passes of a sharded frontier, 0 = never
#: (MYTHRIL_TPU_STEAL_CADENCE)
STEAL_CADENCE = 4
#: the least load gap at which a shard pair exchanges rows
#: (MYTHRIL_TPU_STEAL_MIN_IMBALANCE)
STEAL_MIN_IMBALANCE = 8

#: words of the summary before its per-lane blocks
SUMMARY_SCALARS = 13

#: int32 section of a packed row block, one word per row each, in order
_DRAIN_I32_FIELDS = ("pc", "sp", "msize", "code_len", "cond_count",
                     "ctx_id", "last_jump", "branches")
_PLANE_FIELDS = frozenset(("cond_count", "ctx_id", "last_jump", "branches"))


# ---- the device programs (twins) ------------------------------------------------------

class LoopHintAnnotation(StateAnnotation):
    """Rides on materialized lanes whose pc sits inside a natural loop
    (taint summary's per-loop-header hint tables): the bounded-unroll
    budgeter groups lanes by header pc to cap per-loop lane spend. A copy
    of mythril_tpu/parallel/frontier.py:508-520; the port's
    `core/strategy/bounded_loops.py` looks it up in this module."""

    __slots__ = ("header_pc",)

    def __init__(self, header_pc: int):
        self.header_pc = header_pc

    def __copy__(self):
        return LoopHintAnnotation(self.header_pc)


def summary_reference(state: StateBatch, planes: SymPlanes, arena: A.Arena,
                      sched: symstep.DeviceScheduler) -> torch.Tensor:
    """Plain twin of kernel K5 (`_summary`, frontier.py:99): int64[13 + 3B]
    = [stack_top, esc_count, executed, forks, pushes, pops, arena_n,
    arena_n_const, esc_msize_max, esc_sp_max, esc_slots_max,
    esc_conds_max, batch] + status[B] + fork_cond[B] + ctx_id[B], then,
    with the plane armed, `symstep.telemetry_words` (frontier.py:138).
    Maxima run over the live escape rows (row < its segment's count), 0
    when none is. A sharded scheduler reports the global sums in slots 0/1
    and appends the shard block [stack_top[D], esc_count[D],
    steals_sent[D], steals_received[D], steal_rows] after the telemetry
    words (frontier.py:146-153)."""
    symstep._check_scheduler(sched)
    dev = state.status.device
    esc_rows = sched.esc_state.status.shape[0]
    ecount_vec = sched.esc_count.reshape(-1).to(I64)
    seg_esc = esc_rows // ecount_vec.shape[0]
    live = (torch.arange(esc_rows, device=dev) % seg_esc) \
        < torch.repeat_interleave(ecount_vec, seg_esc)

    def live_max(column):
        return torch.where(live, column.to(I64), 0).max()

    batch = state.status.shape[0]
    scalars = torch.stack([
        sched.stack_top.to(I64).sum(), ecount_vec.sum(),
        sched.executed, sched.forks, sched.pushes, sched.pops,
        arena.n.to(I64), arena.n_const.to(I64),
        live_max(sched.esc_state.msize), live_max(sched.esc_state.sp),
        live_max(sched.esc_state.storage_used.sum(1, dtype=I32)),
        live_max(sched.esc_planes.cond_count),
        torch.tensor(batch, dtype=I64, device=dev)])
    parts = [scalars, state.status.to(I64), planes.fork_cond.to(I64),
             planes.ctx_id.to(I64)]
    if sched.telemetry is not None:
        parts.append(symstep.telemetry_words(sched.telemetry))
    if sched.stack_top.dim() == 1:
        parts += [sched.stack_top.to(I64), ecount_vec, sched.steals_sent,
                  sched.steals_received, sched.steal_rows.reshape(1)]
    return torch.cat(parts)


def _rows(index: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Gather index as JAX reads it: out-of-range entries clamp."""
    return index.to(I64).clamp(0, n_rows - 1)


def row_maxima_reference(state_like: StateBatch, planes_like: SymPlanes,
                         index: torch.Tensor) -> torch.Tensor:
    """Plain twin of K6's `row_maxima` (`_row_maxima`, frontier.py:191):
    int64[4] = the maxima of msize, sp, used storage slots and cond_count
    over the selected rows."""
    idx = _rows(index, state_like.msize.shape[0])
    return torch.stack([
        state_like.msize[idx].max().to(I64),
        state_like.sp[idx].max().to(I64),
        state_like.storage_used[idx].sum(1, dtype=I32).max().to(I64),
        planes_like.cond_count[idx].max().to(I64)])


def pack_rows_reference(state_like: StateBatch, planes_like: SymPlanes,
                        index: torch.Tensor, mem_b: int, sp_b: int,
                        st_b: int, conds_w: int):
    """Plain twin of K6's `pack_rows` (`_pack_rows`, frontier.py:156): the
    selected rows' materialization fields, each cut to the static widths,
    as three flat blocks (int32, uint8, int64 gas) in `drain_unpack`'s
    layout. uint32 limbs ride the int32 block as their bit patterns."""
    s, p = state_like, planes_like
    idx = _rows(index, s.pc.shape[0])
    i32 = torch.cat([
        s.pc[idx], s.sp[idx], s.msize[idx], s.code_len[idx],
        p.cond_count[idx], p.ctx_id[idx], p.last_jump[idx], p.branches[idx],
        s.stack[idx][:, :sp_b].reshape(-1),
        s.storage_keys[idx][:, :st_b].reshape(-1),
        s.storage_vals[idx][:, :st_b].reshape(-1),
        p.stack_sym[idx][:, :sp_b].reshape(-1),
        p.mem_sym[idx][:, :mem_b].reshape(-1),
        p.storage_sym[idx][:, :st_b].reshape(-1),
        p.conds[idx][:, :conds_w].reshape(-1)])
    u8 = torch.cat([
        s.memory[idx][:, :mem_b].reshape(-1),
        s.storage_used[idx][:, :st_b].to(torch.uint8).reshape(-1),
        p.storage_dirty[idx][:, :st_b].to(torch.uint8).reshape(-1)])
    return i32, u8, s.gas_used[idx]


def reset_esc_reference(sched: symstep.DeviceScheduler):
    """Plain twin of K6's `reset_esc` (`_reset_esc`, frontier.py:248): the
    escape count (every segment's) goes to 0, in place."""
    sched.esc_count.zero_()
    return sched


def gather_rows_reference(state: StateBatch, planes: SymPlanes,
                          index: torch.Tensor):
    """Plain twin of K7's gather (`_gather_rows`, frontier.py:79): the
    selected rows of every leaf, as new (StateBatch, SymPlanes)."""
    idx = _rows(index, state.status.shape[0])
    return (StateBatch(*[leaf[idx] for leaf in state]),
            SymPlanes(*[leaf[idx] for leaf in planes]))


def scatter_rows_reference(state: StateBatch, planes: SymPlanes,
                           index: torch.Tensor, rows_state: StateBatch,
                           rows_planes: SymPlanes):
    """Plain twin of K7's scatter (`_scatter_rows`, frontier.py:88): row i
    of every leaf of (rows_state, rows_planes) goes to lane index[i], in
    place; an index outside [0, lanes) is dropped."""
    batch = state.status.shape[0]
    keep = torch.nonzero((index >= 0) & (index < batch)).flatten()
    dst = index[keep].to(I64)
    for leaf, rows in zip(list(state) + list(planes),
                          list(rows_state) + list(rows_planes)):
        leaf[dst] = rows[keep].to(leaf.dtype)
    return state, planes


def pack_steal_rows_reference(state_like: StateBatch, planes_like: SymPlanes,
                              index: torch.Tensor, mem_b: int, sp_b: int,
                              st_b: int, conds_w: int):
    """Plain twin of `_pack_steal_rows` (frontier.py:252): the escape-row
    codec (`pack_rows_reference`) with the rows' `status` and `fork_cond`
    appended to the int32 block."""
    i32, u8, gas = pack_rows_reference(state_like, planes_like, index, mem_b,
                                       sp_b, st_b, conds_w)
    idx = _rows(index, state_like.status.shape[0])
    return (torch.cat([i32, state_like.status[idx].to(I32),
                       planes_like.fork_cond[idx].to(I32)]), u8, gas)


def unpack_steal_rows_reference(i32: torch.Tensor, u8: torch.Tensor,
                                gas: torch.Tensor, bucket: int, mem_b: int,
                                sp_b: int, st_b: int, conds_w: int):
    """Plain twin of `_unpack_steal_rows` (frontier.py:267), the device-side
    inverse of `pack_steal_rows_reference`: two dicts of row tensors keyed
    like StateBatch / SymPlanes fields (limbs as int32 bit patterns)."""
    limbs = words.NLIMBS
    offset = [0]

    def cut(count, shape=None):
        part = i32[offset[0]:offset[0] + count]
        offset[0] += count
        return part.reshape(shape) if shape else part

    rows_state: Dict[str, torch.Tensor] = {}
    rows_planes: Dict[str, torch.Tensor] = {}
    for field in _DRAIN_I32_FIELDS:
        target = rows_planes if field in _PLANE_FIELDS else rows_state
        target[field] = cut(bucket)
    rows_state["stack"] = cut(bucket * sp_b * limbs, (bucket, sp_b, limbs))
    rows_state["storage_keys"] = cut(bucket * st_b * limbs,
                                     (bucket, st_b, limbs))
    rows_state["storage_vals"] = cut(bucket * st_b * limbs,
                                     (bucket, st_b, limbs))
    rows_planes["stack_sym"] = cut(bucket * sp_b, (bucket, sp_b))
    rows_planes["mem_sym"] = cut(bucket * mem_b, (bucket, mem_b))
    rows_planes["storage_sym"] = cut(bucket * st_b, (bucket, st_b))
    rows_planes["conds"] = cut(bucket * conds_w, (bucket, conds_w))
    rows_state["status"] = cut(bucket)
    rows_planes["fork_cond"] = cut(bucket)
    rows_state["memory"] = u8[:bucket * mem_b].reshape(bucket, mem_b)
    rows_state["storage_used"] = u8[
        bucket * mem_b:bucket * (mem_b + st_b)].reshape(
            bucket, st_b).to(torch.bool)
    rows_planes["storage_dirty"] = u8[
        bucket * (mem_b + st_b):bucket * (mem_b + 2 * st_b)].reshape(
            bucket, st_b).to(torch.bool)
    rows_state["gas_used"] = gas
    return rows_state, rows_planes


def steal_plan(status: torch.Tensor, stack_top: torch.Tensor, seg_pool: int,
               min_imbalance: int, max_rows: int):
    """The steal pass's decision (frontier.py:337-363) as host numbers:
    [(poor, rich, n)] for each disjoint pair. Load is a block's RUNNING
    lanes plus its segment's pending rows; shards are ordered by a stable
    ascending sort of the load (ties to the lower shard), order[i] pairs
    with order[D-1-i], and a pair moves min(diff // 2, max_rows,
    top[rich], seg_pool - top[poor]) rows, none below `min_imbalance`."""
    n_seg = stack_top.shape[0]
    load = (status == RUNNING).reshape(n_seg, -1).sum(1).to(I64) \
        + stack_top.to(I64)
    order = torch.argsort(load, stable=True).tolist()
    load, top = load.tolist(), stack_top.tolist()
    pairs = []
    for i in range(n_seg // 2):
        poor, rich = order[i], order[n_seg - 1 - i]
        diff = load[rich] - load[poor]
        n = min(diff // 2, max_rows, top[rich], seg_pool - top[poor])
        pairs.append((poor, rich, max(n, 0) if diff >= min_imbalance else 0))
    return pairs


def steal_pass_reference(state: StateBatch, sched: symstep.DeviceScheduler,
                         min_imbalance: int, max_rows: int):
    """Plain twin of K12 (`_steal_pass`, frontier.py:319): for each pair of
    `steal_plan`, the donor's top n pending rows (from its top downward)
    go through the steal-row codec, composed with the full rows for the
    leaves it does not carry, and land at the receiver's top upward. Donor
    rows above its new top are left as they are. Tops and steal counters
    are updated; everything in place. Returns the scheduler."""
    pool_state, pool_planes = sched.stack_state, sched.stack_planes
    pool_rows = pool_state.status.shape[0]
    seg_pool = pool_rows // symstep.n_segments(sched)
    widths = (pool_state.memory.shape[1], pool_state.stack.shape[1],
              pool_state.storage_keys.shape[1], pool_planes.conds.shape[1])
    dev = state.status.device
    r = torch.arange(max_rows, dtype=I64, device=dev)
    for poor, rich, n in steal_plan(state.status, sched.stack_top, seg_pool,
                                    min_imbalance, max_rows):
        top_rich = int(sched.stack_top[rich])
        top_poor = int(sched.stack_top[poor])
        src = (rich * seg_pool + top_rich - 1 - r).clamp(0, pool_rows - 1)
        rows_state, rows_planes = gather_rows_reference(pool_state,
                                                        pool_planes, src)
        unp_state, unp_planes = unpack_steal_rows_reference(
            *pack_steal_rows_reference(pool_state, pool_planes, src,
                                       *widths), max_rows, *widths)
        rows_state = rows_state._replace(**unp_state)
        rows_planes = rows_planes._replace(**unp_planes)
        dst = torch.where(r < n, poor * seg_pool + top_poor + r, pool_rows)
        keep = dst < pool_rows
        for leaf, rows in zip(list(pool_state) + list(pool_planes),
                              list(rows_state) + list(rows_planes)):
            leaf[dst[keep]] = rows[keep]
        sched.stack_top[rich] -= n
        sched.stack_top[poor] += n
        sched.steals_sent[rich] += n
        sched.steals_received[poor] += n
        sched.steal_rows.add_(n)
    return sched


# ---- dispatch: the kernel on CUDA tensors, the twin on the CPU ----------------------

def summary(state, planes, arena, sched) -> torch.Tensor:
    """The chunk summary: kernel K5 on CUDA tensors, the twin on the CPU."""
    if state.status.is_cuda:
        symstep._check_scheduler(sched)
        from ..kernels import ops

        return ops.frontier_summary(state, planes, arena, sched)
    return summary_reference(state, planes, arena, sched)


def summary_read(state, planes, arena, sched) -> np.ndarray:
    """The chunk summary on the host: the drain loop's one blocking read
    (K5's output copied back on CUDA tensors, the twin's on the CPU)."""
    return summary(state, planes, arena, sched).cpu().numpy()


def row_maxima(state_like, planes_like, index) -> torch.Tensor:
    """Row maxima: kernel K6 on CUDA tensors, the twin on the CPU."""
    if state_like.status.is_cuda:
        from ..kernels import ops

        return ops.row_maxima(state_like, planes_like, index)
    return row_maxima_reference(state_like, planes_like, index)


def pack_rows(state_like, planes_like, index, mem_b: int, sp_b: int,
              st_b: int, conds_w: int):
    """Row packing: kernel K6 on CUDA tensors, the twin on the CPU."""
    if state_like.status.is_cuda:
        from ..kernels import ops

        return ops.pack_rows(state_like, planes_like, index, mem_b, sp_b,
                             st_b, conds_w)
    return pack_rows_reference(state_like, planes_like, index, mem_b, sp_b,
                               st_b, conds_w)


def reset_esc(sched):
    """Escape-count reset: kernel K6 on CUDA tensors, the twin on the CPU."""
    if sched.esc_count.is_cuda:
        from ..kernels import ops

        return ops.reset_esc(sched)
    return reset_esc_reference(sched)


def steal_pass(state, sched, min_imbalance: int, max_rows: int):
    """The work-stealing pass of a sharded scheduler, in place: kernel K12
    on CUDA tensors (no host read: the plan and the sizes stay on the
    card), the twin on the CPU."""
    if symstep.n_segments(sched) < 2:
        raise ValueError("steal_pass needs a sharded scheduler")
    if state.status.is_cuda:
        from ..kernels import ops

        return ops.steal_pass(state, sched, min_imbalance, max_rows)
    return steal_pass_reference(state, sched, min_imbalance, max_rows)


def gather_rows(state, planes, index):
    """Row gather: kernel K7 on CUDA tensors, the twin on the CPU."""
    if state.status.is_cuda:
        from ..kernels import ops

        return ops.gather_rows(state, planes, index)
    return gather_rows_reference(state, planes, index)


def gather_rows_flat(state, planes, index):
    """Row gather into one flat uint8 buffer laid out by
    `batch.row_layout`: kernel K7 on CUDA tensors, the twin's rows copied
    into such a buffer on the CPU. Returns (buffer, slabs)."""
    if state.status.is_cuda:
        from ..kernels import ops

        flat, plan = ops.gather_rows_flat(state, planes, index)
        return flat, plan.slabs
    leaves = list(state) + list(planes)
    slabs, total = row_layout(leaves, index.shape[0])
    flat = torch.zeros(total, dtype=torch.uint8)
    rows = gather_rows_reference(state, planes, index)
    for view, block in zip(row_views(flat, slabs), list(rows[0]) + list(rows[1])):
        view.copy_(block)
    return flat, slabs


def scatter_rows(state, planes, index, rows_state, rows_planes):
    """Row scatter, in place: kernel K7 on CUDA tensors, the twin on the
    CPU."""
    if state.status.is_cuda:
        from ..kernels import ops

        return ops.scatter_rows(state, planes, index, rows_state, rows_planes)
    return scatter_rows_reference(state, planes, index, rows_state,
                                  rows_planes)


# ---- host helpers (plain numpy) -----------------------------------------------------

def drain_unpack(i32: np.ndarray, u8: np.ndarray, gas: np.ndarray,
                 bucket: int, mem_b: int, sp_b: int, st_b: int,
                 conds_w: int):
    """Host inverse of `pack_rows` (frontier.py:203): two dicts of numpy
    row arrays, keyed like StateBatch / SymPlanes fields, in the JAX
    package's dtypes (limbs as uint32, flags as bool)."""
    limbs = words.NLIMBS
    i32 = np.asarray(i32)
    u8 = np.asarray(u8)
    offset = [0]

    def cut(count, shape=None, view=None):
        part = i32[offset[0]:offset[0] + count]
        offset[0] += count
        if view is not None:
            part = part.view(view)
        return part.reshape(shape) if shape else part

    rows_state: Dict[str, np.ndarray] = {}
    rows_planes: Dict[str, np.ndarray] = {}
    for field in _DRAIN_I32_FIELDS:
        target = rows_planes if field in _PLANE_FIELDS else rows_state
        target[field] = cut(bucket)
    rows_state["stack"] = cut(bucket * sp_b * limbs, (bucket, sp_b, limbs),
                              np.uint32)
    rows_state["storage_keys"] = cut(bucket * st_b * limbs,
                                     (bucket, st_b, limbs), np.uint32)
    rows_state["storage_vals"] = cut(bucket * st_b * limbs,
                                     (bucket, st_b, limbs), np.uint32)
    rows_planes["stack_sym"] = cut(bucket * sp_b, (bucket, sp_b))
    rows_planes["mem_sym"] = cut(bucket * mem_b, (bucket, mem_b))
    rows_planes["storage_sym"] = cut(bucket * st_b, (bucket, st_b))
    rows_planes["conds"] = cut(bucket * conds_w, (bucket, conds_w))
    rows_state["memory"] = u8[:bucket * mem_b].reshape(bucket, mem_b)
    rows_state["storage_used"] = u8[
        bucket * mem_b:bucket * (mem_b + st_b)].reshape(
            bucket, st_b).astype(bool)
    rows_planes["storage_dirty"] = u8[
        bucket * (mem_b + st_b):bucket * (mem_b + 2 * st_b)].reshape(
            bucket, st_b).astype(bool)
    rows_state["gas_used"] = np.asarray(gas)
    return rows_state, rows_planes


def pool_used_indices(counts, pool_rows: int) -> np.ndarray:
    """Row index of a pool's used rows (frontier.py:1700): the prefix
    [0, count), or with per-segment counts the concatenation of each
    segment's prefix."""
    counts = np.atleast_1d(np.asarray(counts))
    seg = pool_rows // len(counts)
    parts = [np.arange(d * seg, d * seg + int(c), dtype=np.int64)
             for d, c in enumerate(counts)]
    return (np.concatenate(parts) if parts
            else np.zeros(0, dtype=np.int64))


def quantize(value: int, steps: Sequence[int], cap: int) -> int:
    """The first step at or above `value`, at most `cap` (frontier.py:1626):
    a few coarse pack widths instead of exact fits."""
    for step in steps:
        if value <= step:
            return min(step, cap)
    return cap


def pack_widths(state_like, planes_like, msize_m: int, sp_m: int, st_m: int,
                conds_m: int) -> Tuple[int, int, int, int]:
    """(mem_b, sp_b, st_b, conds_w) of a pack, from the rows' maxima
    (frontier.py:1632-1636)."""
    return (quantize(msize_m, (1, 32, 512), planes_like.mem_sym.shape[1]),
            quantize(sp_m, (4, 16), state_like.stack.shape[1]),
            quantize(st_m, (1, 8), state_like.storage_keys.shape[1]),
            quantize(conds_m, (16,), planes_like.conds.shape[1]))


def deferred_digest(deferred) -> str:
    """sha256 over deferred row blocks, in order: each block's count, then
    every array (field name, dtype, shape, bytes) of its state and planes
    dicts in sorted field order."""
    sha = hashlib.sha256()
    for rows_state, rows_planes, count, _cursor in deferred:
        sha.update(str(int(count)).encode())
        for rows in (rows_state, rows_planes):
            for field in sorted(rows):
                array = np.ascontiguousarray(rows[field])
                sha.update(f"{field}:{array.dtype.str}:{array.shape}"
                           .encode())
                sha.update(array.tobytes())
    return sha.hexdigest()


def mirror_digest(harena) -> str:
    """sha256 over a host arena mirror: its node columns [0, n), then its
    const rows [0, n_const) as uint32."""
    sha = hashlib.sha256()
    for col in A.ROW_COLS:
        sha.update(np.ascontiguousarray(getattr(harena, col)[:harena.n])
                   .tobytes())
    sha.update(np.ascontiguousarray(harena.const_vals[:harena.n_const])
               .astype(np.uint32).tobytes())
    return sha.hexdigest()


# ---- the static tables ----------------------------------------------------------------

def disassembly_of(code: bytes,
                   disassemblies: Dict[bytes, Disassembly]) -> Disassembly:
    """The `Disassembly` of `code` in `disassemblies` (made there on first
    use): the static analyses memoize on the instance, so its owner, a
    frontier or one `static_tables` call, builds each code's once."""
    code = bytes(code)
    dis = disassemblies.get(code)
    if dis is None:
        dis = disassemblies[code] = Disassembly(code.hex())
    return dis


def warm_static(codes: Sequence[bytes],
                disassemblies: Dict[bytes, Disassembly]) -> None:
    """Build each code's CFA, absint tables and summary now, outside the
    step loop (the JAX `seed`, frontier.py:968, 971)."""
    for code in codes:
        disassembly = disassembly_of(code, disassemblies)
        cfa_screen.warm(disassembly)
        module_screen.warm(disassembly)


def _tag_table(codes: Sequence[Disassembly]) -> Tuple[List[int], List[str]]:
    """`_collect_tag_pcs` (frontier.py:753): loop headers first, then
    post-dominator merge points, deduplicated, at most TAG_SLOTS."""
    loops: List[Tuple[int, str]] = []
    merges: List[Tuple[int, str]] = []
    seen = set()
    for code in codes:
        summary = module_screen.summary_for(code)
        if summary is not None:
            for loop in summary.loops:
                key = ("loop", loop.header_pc)
                if key not in seen:
                    seen.add(key)
                    loops.append((loop.header_pc,
                                  f"loop@{loop.header_pc:#x}"))
        cfa = cfa_screen.cfa_for(code)
        if cfa is not None:
            for pc in sorted(cfa.merge_points):
                key = ("merge", pc)
                if key not in seen:
                    seen.add(key)
                    merges.append((pc, f"merge@{pc:#x}"))
    tags = (loops + merges)[:TAG_SLOTS]
    return [pc for pc, _ in tags], [name for _, name in tags]


def _merge_table(codes: Sequence[Disassembly], absint: bool) -> tuple:
    """`_merge_pc_table` (frontier.py:816): the merge-attribution pcs and
    names (at most MERGE_PC_SLOTS) and the widened merge's window table,
    one row per join-block pc that a join's proven windows cover
    (`mem_pcs` int32[J], `mem_words` int32[J, W] padded with -1; (0, 1)
    when there is none)."""
    pcs: List[int] = []
    names: List[str] = []
    seen = set()
    mem_map: Dict[int, Tuple[int, ...]] = {}
    for code in codes:
        cfa = cfa_screen.cfa_for(code)
        if cfa is None:
            continue
        for pc in sorted(cfa.merge_points):
            if pc not in seen:
                seen.add(pc)
                pcs.append(pc)
                names.append(f"merge@{pc:#x}")
            if absint and pc not in mem_map:
                windows = cfa_screen.merge_mem_windows(code, pc)
                if windows:
                    for row_pc in cfa_screen.merge_window_pcs(code, pc):
                        mem_map.setdefault(row_pc, tuple(windows))
    pcs, names = pcs[:MERGE_PC_SLOTS], names[:MERGE_PC_SLOTS]
    mem_items = sorted(mem_map.items())[:MERGE_PC_SLOTS]
    if mem_items:
        width = max(len(w) for _, w in mem_items)
        mem_pcs = np.asarray([pc for pc, _ in mem_items], dtype=np.int32)
        mem_words = np.full((len(mem_items), width), -1, dtype=np.int32)
        for i, (_, w) in enumerate(mem_items):
            mem_words[i, :len(w)] = w
    else:
        mem_pcs = np.zeros(0, dtype=np.int32)
        mem_words = np.zeros((0, 1), dtype=np.int32)
    return np.asarray(pcs, dtype=np.int32), names, mem_pcs, mem_words


def static_tables(codes: Sequence[bytes], telemetry: bool = True,
                  state_merge: bool = True, absint: Optional[bool] = None,
                  disassemblies: Optional[Dict[bytes, Disassembly]] = None
                  ) -> dict:
    """The static tables of a frontier whose seeds run `codes` (seed
    order), as `DeviceFrontier`'s table arguments: `tag_pcs`/`tag_names`
    (empty with telemetry off), `merge_pcs`/`merge_names` and the window
    table `mem_pcs`/`mem_words` (empty with merging off; the window table
    also with `absint` off, which defaults to `cfa_screen.absint_enabled`).
    Each code's analyses are built once, on its Disassembly in
    `disassemblies` (a fresh dict, unless the caller keeps one)."""
    if absint is None:
        absint = cfa_screen.absint_enabled()
    if disassemblies is None:
        disassemblies = {}
    disassemblies = [disassembly_of(code, disassemblies) for code in codes]
    tag_pcs, tag_names = _tag_table(disassemblies) if telemetry else ([], [])
    if state_merge:
        merge_pcs, merge_names, mem_pcs, mem_words = _merge_table(
            disassemblies, absint)
    else:
        merge_pcs, merge_names = np.zeros(0, dtype=np.int32), []
        mem_pcs = np.zeros(0, dtype=np.int32)
        mem_words = np.zeros((0, 1), dtype=np.int32)
    return {"tag_pcs": tag_pcs, "tag_names": tag_names,
            "merge_pcs": merge_pcs, "merge_names": merge_names,
            "mem_pcs": mem_pcs, "mem_words": mem_words}


TABLE_KEYS = ("tag_pcs", "tag_names", "merge_pcs", "merge_names", "mem_pcs",
              "mem_words")


# ---- the driver ---------------------------------------------------------------------

#: (code, concrete storage {key: value}, storage base symbolic, gas limit,
#: address) of one seed
Seed = Tuple[bytes, Dict[int, int], bool, int, int]

#: service_cold(frontier, state, planes, status, lanes) -> (state, planes):
#: fault the lanes' cold storage slots in, setting status[lane] on the host
ColdService = Callable[..., Tuple[StateBatch, SymPlanes]]


class DeviceFrontier:
    """The device half of `_Frontier` (frontier.py:558): seeding, scheduler
    sizing, the chunk loop with its drains, merges and telemetry, and the
    hand-over of what is left when the budget runs out. Settings are the
    JAX knobs' defaults: `stack_bytes`/`esc_bytes`
    MYTHRIL_TPU_STACK_BYTES/ESC_BYTES, `drain_batch`
    MYTHRIL_TPU_DRAIN_BATCH (None: max(4 lanes, 1024)), `chunk` and
    `max_steps` MYTHRIL_TPU_CHUNK/MAX_STEPS, `telemetry` and `state_merge`
    MYTHRIL_TPU_FRONTIER_TELEMETRY/STATE_MERGE (both on), `n_shards`
    MYTHRIL_TPU_FLEET_SHARD (1 on one card; validated by
    `batch.shard_count`, so one that does not divide the lanes falls back
    to 1), `steal_cadence`/`steal_min_imbalance`
    MYTHRIL_TPU_STEAL_CADENCE/STEAL_MIN_IMBALANCE.

    The static tables are those the JAX frontier's `_collect_tag_pcs`
    (frontier.py:753) and `_merge_pc_table` (816) give: `tag_pcs`/
    `tag_names` (at most TAG_SLOTS; names "merge@0x..", "loop@0x.."),
    `merge_pcs`/`merge_names` (at most MERGE_PC_SLOTS) and the window table
    `mem_pcs` int32[J] / `mem_words` int32[J, W] (-1 padded). Unless the
    caller hands any of them in, `seed` builds them from its seeds' codes
    with `static_tables` (after warming each code's CFA and summary, as
    the JAX `seed` does, on the frontier's own Disassembly of each code),
    `cfa_screen.absint_enabled()` at construction deciding the window
    table, as the JAX frontier reads it. Tables handed in are used as they are; empty
    ones behave as the JAX frontier does without the CFA: no tags, strict
    merging on the 4-chunk cadence.

    A fleet caller also hands in what `FleetDriver` sets on the JAX
    frontier: `seed_owner_index` (each seed's owner shard, round robin
    without it) and the telemetry's fleet block, `fleet_slots` (seed
    index -> slot) and `fleet_names` (one per slot), the shape of
    `_collect_fleet_slots` (frontier.py:787)."""

    def __init__(self, n_lanes: int = DEFAULT_LANES, device=None,
                 chunk: int = CHUNK, max_steps: int = MAX_STEPS,
                 stack_bytes: int = 3 << 30, esc_bytes: int = 1 << 30,
                 drain_batch: Optional[int] = None,
                 arena: Optional[A.Arena] = None,
                 service_cold: Optional[ColdService] = None,
                 telemetry: bool = True, state_merge: bool = True,
                 tag_pcs: Optional[Sequence[int]] = None,
                 tag_names: Optional[Sequence[str]] = None,
                 merge_pcs: Optional[Sequence[int]] = None,
                 merge_names: Optional[Sequence[str]] = None,
                 mem_pcs=None, mem_words=None, n_shards: int = 1,
                 steal_cadence: int = STEAL_CADENCE,
                 steal_min_imbalance: int = STEAL_MIN_IMBALANCE,
                 seed_owner_index: Optional[Sequence[int]] = None,
                 fleet_slots: Sequence[int] = (),
                 fleet_names: Sequence[str] = ()):
        self.n_lanes = n_lanes
        self.device = _device.resolve(device)
        self.chunk = chunk
        self.max_steps = max_steps
        self.stack_bytes = stack_bytes
        self.esc_bytes = esc_bytes
        self.drain_batch = (max(4 * n_lanes, 1024) if drain_batch is None
                            else drain_batch)
        self.arena = arena if arena is not None \
            else A.new_arena(device=self.device)
        self.harena: Optional[A.HostArena] = None
        self.service_cold = service_cold
        #: drained-but-unmaterialized row blocks: [rows_state, rows_planes,
        #: count, cursor] (the host engine reads them lazily)
        self.deferred: List[list] = []
        #: host overflow tier: full rows spilled at a deadlock, reseeded
        #: into DEAD lanes once the device stack is empty
        self.pending: List[Tuple[Dict[str, np.ndarray],
                                 Dict[str, np.ndarray]]] = []
        self.lane_steps = 0    # instruction-states executed on the device
        self.forks = 0
        self.stack_pushes = 0
        self.stack_pops = 0
        self.spilled = 0       # rows spilled to the host tier
        self.reseeded = 0      # rows reseeded from the host tier
        self.chunks = 0
        self.drains = 0        # bulk drains of the escape buffer
        self.drained_rows = 0
        self.frozen_rows = 0   # lanes deferred frozen ESCAPED
        self.row_bytes = 0
        self.telemetry = telemetry
        self.state_merge = state_merge
        self.absint = cfa_screen.absint_enabled()
        given = (tag_pcs, tag_names, merge_pcs, merge_names, mem_pcs,
                 mem_words)
        #: the tables are built in `seed` from the seeds' codes (in order)
        #: unless the caller handed any in
        self.own_tables = all(table is None for table in given)
        self.seed_codes: List[bytes] = []
        #: one Disassembly per seeded code, which its analyses memoize on
        self.disassemblies: Dict[bytes, Disassembly] = {}
        self._set_tables(*(() if table is None else table
                           for table in given))
        #: telemetry: this phase's last raw words (cumulative on the
        #: device), the last chunk's merge-tag deltas (the merge trigger)
        #: and the deltas summed over every phase
        self.tel_words: Optional[np.ndarray] = None
        self.last_tag_delta: Optional[np.ndarray] = None
        self.op_hist = np.zeros(symstep.N_OP_CLASSES, dtype=np.int64)
        self.lifecycle = np.zeros(symstep.N_LIFECYCLE, dtype=np.int64)
        self.esc_cause = np.zeros(symstep.N_ESC_CAUSES, dtype=np.int64)
        self.stack_hwm = self.esc_hwm = 0
        #: merging: passes run, pairs collapsed (one lane retired each),
        #: ITE nodes blended, memory windows blended, refusals by gate,
        #: merges by merge tag and pairs by blended-slot count
        self.merge_passes = 0
        self.merges = 0
        self.merge_ites = 0
        self.mem_blends = 0
        self.blocked_by = dict.fromkeys(symstep.MERGE_BLOCKED_LABELS, 0)
        self.tag_merges: Dict[str, int] = {}
        self.ite_depth = dict.fromkeys(symstep.MERGE_DEPTH_LABELS, 0)
        #: fleet: seed owners and the telemetry's per-member slots
        if len(fleet_names) > TAG_SLOTS or any(
                not 0 <= slot < len(fleet_names) for slot in fleet_slots):
            raise ValueError(f"fleet_slots/fleet_names: slots must index "
                             f"at most {TAG_SLOTS} names")
        self.seed_owner_index = (None if seed_owner_index is None
                                 else [int(v) for v in seed_owner_index])
        self.fleet_slots = [int(slot) for slot in fleet_slots]
        self.fleet_names = list(fleet_names)
        self.fleet_occupancy = np.zeros(len(self.fleet_names), dtype=np.int64)
        #: logical shards and stealing; the last summary's shard block
        #: (per-shard tops and escape counts feed the drains) and the steal
        #: counters' deltas summed over every phase
        self.n_shards = shard_count(n_lanes, int(n_shards))
        self.steal_cadence = steal_cadence
        self.steal_min_imbalance = steal_min_imbalance
        self.steal_passes = 0
        self.shard_tops: Optional[np.ndarray] = None
        self.shard_esc: Optional[np.ndarray] = None
        self.shard_steals: Optional[tuple] = None
        self.steals_sent = np.zeros(self.n_shards, dtype=np.int64)
        self.steals_received = np.zeros(self.n_shards, dtype=np.int64)
        self.steal_rows = 0
        self.shard_imbalance = 0
        self.shard_fairness = 1.0

    def _set_tables(self, tag_pcs, tag_names, merge_pcs, merge_names,
                    mem_pcs, mem_words) -> None:
        """Check and keep the static tables, and put K10's on the device
        once: every merge pass gets the same tensors, so K10's plan (keyed
        on them) serves all."""
        if len(tag_pcs) != len(tag_names) or len(tag_pcs) > TAG_SLOTS:
            raise ValueError(f"tag_pcs/tag_names: {len(tag_pcs)} pcs, "
                             f"{len(tag_names)} names, at most {TAG_SLOTS}")
        if len(merge_pcs) != len(merge_names) \
                or len(merge_pcs) > MERGE_PC_SLOTS:
            raise ValueError("merge_pcs/merge_names: lengths differ or "
                             f"exceed {MERGE_PC_SLOTS}")
        self.tag_pcs = [int(pc) for pc in tag_pcs]
        self.tag_names = list(tag_names)
        self.merge_pcs = np.asarray(merge_pcs, dtype=np.int32)
        self.merge_names = list(merge_names)
        if not len(mem_pcs):
            self.mem_pcs = np.zeros(0, dtype=np.int32)
            self.mem_words = np.zeros((0, 1), dtype=np.int32)
        else:
            self.mem_pcs = np.asarray(mem_pcs, dtype=np.int32)
            self.mem_words = np.asarray(mem_words, dtype=np.int32)
            if self.mem_words.shape[0] != self.mem_pcs.shape[0] \
                    or len(self.mem_pcs) > MERGE_PC_SLOTS:
                raise ValueError("mem_pcs/mem_words: one window row per pc, "
                                 f"at most {MERGE_PC_SLOTS}")
        self.merge_tables = symstep._merge_tables(
            self.merge_pcs, self.mem_pcs, self.mem_words, self.device)
        self.tag_occupancy = np.zeros(len(self.tag_pcs), dtype=np.int64)

    def tables(self) -> dict:
        """The static tables in use, keyed as `static_tables` returns them."""
        return {"tag_pcs": self.tag_pcs, "tag_names": self.tag_names,
                "merge_pcs": self.merge_pcs, "merge_names": self.merge_names,
                "mem_pcs": self.mem_pcs, "mem_words": self.mem_words}

    def _build_tables(self, codes: Sequence[bytes]) -> None:
        """Warm each code's static analysis (`warm_static`), then, for a
        frontier that owns its tables, build them over every seed so far;
        the device tensors are replaced only when the tables change."""
        warm_static(codes, self.disassemblies)
        self.seed_codes += [bytes(code) for code in codes]
        if not self.own_tables:
            return
        built = static_tables(self.seed_codes, self.telemetry,
                              self.state_merge, self.absint,
                              self.disassemblies)
        current = self.tables()
        if not all(np.array_equal(np.asarray(built[key]),
                                  np.asarray(current[key]))
                   for key in TABLE_KEYS):
            self._set_tables(*(built[key] for key in TABLE_KEYS))

    # -- seeding ------------------------------------------------------------------------

    def seed(self, seeds: Sequence[Seed]) -> Tuple[StateBatch, SymPlanes]:
        """One RUNNING lane per seed at `assign_seed_lanes`'s lane
        (symbolic env), DEAD fillers elsewhere; `ctx_id` is the seed's
        index (frontier.py:914-989 without host terms). The seeds' codes
        go through the static analysis first (`_build_tables`)."""
        if len(seeds) > self.n_lanes:
            raise ValueError(f"{len(seeds)} seeds for {self.n_lanes} lanes")
        self._build_tables([seed[0] for seed in seeds])
        lanes = self.assign_seed_lanes(len(seeds))
        specs = [LaneSpec(code=b"\x00")] * self.n_lanes
        for lane, (code, storage, _base, gas_limit, address) in zip(lanes,
                                                                   seeds):
            specs[lane] = LaneSpec(code=code, storage=storage,
                                   gas_limit=gas_limit, address=address)
        state = build_batch(specs, device=self.device)
        planes = SymPlanes.empty(self.n_lanes, state.stack.shape[1],
                                 state.memory.shape[1],
                                 state.storage_keys.shape[1], MAX_CONDS,
                                 device=self.device)
        state.status.fill_(DEAD)
        if seeds:
            index = torch.tensor(lanes, dtype=I64, device=self.device)
            state.status[index] = RUNNING
            planes.storage_base_sym[index] = torch.tensor(
                [bool(seed[2]) for seed in seeds], dtype=torch.bool,
                device=self.device)
            planes.ctx_id[index] = torch.arange(len(seeds), dtype=I32,
                                                device=self.device)
        return state, planes

    def assign_seed_lanes(self, n_seeds: int) -> List[int]:
        """Lane of each seed (frontier.py:991): identity on one shard;
        sharded, seed i goes to the block of `seed_owner_index[i]` (round
        robin without it), filling each block in order and overflowing a
        full block into the next with room."""
        if self.n_shards <= 1:
            return list(range(n_seeds))
        per_block = self.n_lanes // self.n_shards
        owners = self.seed_owner_index
        cursor = [0] * self.n_shards
        lanes: List[int] = []
        for i in range(n_seeds):
            want = (owners[i] if owners and i < len(owners)
                    else i) % self.n_shards
            block = want
            for probe in range(self.n_shards):
                block = (want + probe) % self.n_shards
                if cursor[block] < per_block:
                    break
            lanes.append(block * per_block + cursor[block])
            cursor[block] += 1
        return lanes

    def new_sched(self, state: StateBatch, planes: SymPlanes
                  ) -> symstep.DeviceScheduler:
        """Scheduler pools sized by byte budget and lane count
        (frontier.py:706-747)."""
        row_bytes = sum(leaf.element_size() * int(np.prod(leaf.shape[1:]))
                        for leaf in list(state) + list(planes))
        stack_rows = int(max(2 * self.n_lanes,
                             min(1 << 17, 24 * self.n_lanes,
                                 self.stack_bytes // max(row_bytes, 1))))
        esc_rows = int(max(2 * self.n_lanes,
                           min(1 << 16, 8 * self.n_lanes,
                               self.esc_bytes // max(row_bytes, 1))))
        if self.n_shards > 1:  # equal segments: round up to D rows
            stack_rows += (-stack_rows) % self.n_shards
            esc_rows += (-esc_rows) % self.n_shards
        self.row_bytes = row_bytes
        telemetry = None
        if self.telemetry:
            telemetry = symstep.new_telemetry(
                self.tag_pcs, fleet_slots=self.fleet_slots,
                n_fleet=len(self.fleet_names), device=self.device)
            self.tel_words = None  # the device counters restart each phase
            self.last_tag_delta = None
        # so does the shard block
        self.shard_tops = self.shard_esc = self.shard_steals = None
        return symstep.new_scheduler(state, planes, stack_rows, esc_rows,
                                     telemetry=telemetry,
                                     n_shards=self.n_shards)

    def _harena(self, used=None, used_const=None) -> A.HostArena:
        if self.harena is None:
            self.harena = A.HostArena(self.arena, used, used_const)
        else:
            self.harena.refresh(self.arena, used, used_const)
        return self.harena

    # -- the chunk loop -----------------------------------------------------------------

    def run(self, state: StateBatch, planes: SymPlanes,
            deadline_s: Optional[float] = None) -> None:
        """Explore until the tree drains, the step budget or `deadline_s`
        (seconds of device phase) runs out, or the arena nears capacity
        (frontier.py:1068-1363 without the fleet's deadline drain and
        checkpoints). What is left goes to `deferred` (`hand_over`)."""
        chunk = self.chunk
        n = self.n_lanes
        headroom = max(ARENA_HEADROOM, 4 * chunk * n)
        if headroom > self.arena.capacity // 2:
            self.hand_over(state, planes)
            return
        sched = self.new_sched(state, planes)
        stack_rows = sched.stack_state.status.shape[0]
        n_shards = self.n_shards
        # up to a block's worth of rows per pair and pass (frontier.py:1127)
        steal_max_rows = min(max(stack_rows // n_shards, 1),
                             max(16, n // n_shards))
        drain_batch = min(self.drain_batch, sched.esc_state.status.shape[0])
        merge_by_tags = self.telemetry and any(
            name.startswith("merge@") for name in self.tag_names)
        lane_base, fork_base = self.lane_steps, self.forks
        push_base, pop_base = self.stack_pushes, self.stack_pops
        steps = 0
        arena_n = int(self.arena.n)
        backlog = None
        phase_start = time.monotonic()
        while steps < self.max_steps:
            if arena_n > self.arena.capacity - headroom:
                break
            if deadline_s is not None \
                    and time.monotonic() - phase_start > deadline_s:
                break
            state, planes, self.arena, sched = symstep.run_chunk(
                state, planes, self.arena, sched, chunk)
            self.chunks += 1
            steps += chunk
            # the cadenced steal pass: plan and moves stay on the device
            if n_shards > 1 and self.steal_cadence > 0 \
                    and (steps // chunk) % self.steal_cadence == 0:
                sched = steal_pass(state, sched, self.steal_min_imbalance,
                                   steal_max_rows)
                self.steal_passes += 1
            # the chunk is queued: land the previous drain while it runs
            if backlog is not None:
                self._flush_backlog(backlog)
                backlog = None
            packed = summary_read(state, planes, self.arena, sched)
            (stack_top, esc_count, executed, forks, pushes, pops, arena_n,
             arena_nc, esc_msize, esc_sp, esc_slots, esc_conds, status,
             fork_cond) = self._decode_summary(packed,
                                               sched.telemetry is not None)
            self.lane_steps = lane_base + executed
            self.forks = fork_base + forks
            self.stack_pushes = push_base + pushes
            self.stack_pops = pop_base + pops
            dirty = False
            # cold-SLOAD pauses need a host fault-in to progress at all
            cold = np.nonzero((status == FORKING) & (fork_cond == 0))[0]
            if len(cold):
                if self.service_cold is None:
                    raise NotImplementedError(
                        "a cold-SLOAD pause needs the frontier's fault-in "
                        "service _service_cold: ROADMAP A 7")
                self._harena(arena_n, arena_nc)
                state, planes = self.service_cold(
                    self, state, planes, status, [int(l) for l in cold])
                dirty = True
            # escape-buffer overflow: frozen ESCAPED lanes go to deferred
            frozen = np.nonzero(status == ESCAPED)[0]
            if len(frozen):
                self._harena(arena_n, arena_nc)
                self._defer_lanes(state, planes, frozen)
                self.frozen_rows += len(frozen)
                status[frozen] = DEAD
                dirty = True
            # total deadlock with the sibling stack full: spill half the
            # waiting forkers to the host overflow tier
            waiting = (status == FORKING) & (fork_cond != 0)
            # sharded: one full segment wedges its block's forkers while
            # others have room, so the fullest segment triggers
            if n_shards > 1 and self.shard_tops is not None:
                stack_full = int(np.max(self.shard_tops)) \
                    >= stack_rows // n_shards
            else:
                stack_full = stack_top >= stack_rows
            if waiting.any() and not (status == RUNNING).any() \
                    and not (status == DEAD).any() and stack_full:
                lanes = np.nonzero(waiting)[0]
                self._spill_host(state, planes, status,
                                 [int(l) for l in lanes[:max(1, len(lanes)
                                                             // 2)]])
                dirty = True
            # bulk drain: launched now, landed after the next chunk starts
            if esc_count >= drain_batch or (
                    esc_count and stack_top == 0
                    and not (status == RUNNING).any()):
                backlog = self._fetch_escapes(sched, esc_count, esc_msize,
                                              esc_sp, esc_slots, esc_conds,
                                              arena_n, arena_nc)
                sched = reset_esc(sched)
                self.drains += 1
                self.drained_rows += esc_count
                esc_count = 0
            # host overflow rows re-enter once the device stack is empty
            if self.pending and stack_top == 0 and (status == DEAD).any():
                state, planes = self._reseed_host(state, planes, status)
                dirty = True
            if dirty:
                state.status.copy_(torch.from_numpy(status))
            # after the status upload, which would otherwise resurrect the
            # partners a merge retires on the device (frontier.py:1298)
            if self.state_merge and int(np.sum(status == RUNNING)) >= 2:
                if merge_by_tags and self.last_tag_delta is not None:
                    due = any(int(count) >= MERGE_MIN_LANES
                              for name, count in zip(self.tag_names,
                                                     self.last_tag_delta)
                              if name.startswith("merge@"))
                else:
                    due = (steps // chunk) % 4 == 0
                if due:
                    state, planes, self.arena, mstats = symstep.merge_pass(
                        state, planes, self.arena, *self.merge_tables,
                        n_rounds=MERGE_ROUNDS)
                    self._publish_merge(mstats.cpu().numpy())
            if not ((status == RUNNING) | (status == FORKING)).any() \
                    and stack_top == 0 and esc_count == 0 \
                    and not self.pending:
                self._flush_backlog(backlog)
                return
        self._flush_backlog(backlog)
        self.hand_over(state, planes, sched)

    # -- summary, telemetry and merge decoding ----------------------------------------

    def _decode_summary(self, packed: np.ndarray, telemetry: bool) -> tuple:
        """One chunk's summary vector: its shard block and its telemetry
        words published (copied, so that the caller may reuse `packed`);
        returns the twelve scalars the loop reads, then status and
        fork_cond as new int32 arrays."""
        n = self.n_lanes
        # a sharded summary ends in the shard block: peel it off first
        shard_words = None
        if self.n_shards > 1:
            shard_words = packed[-(4 * self.n_shards + 1):]
            packed = packed[:-(4 * self.n_shards + 1)]
        scalars = [int(v) for v in packed[:SUMMARY_SCALARS - 1]]
        base = SUMMARY_SCALARS
        status = packed[base:base + n].astype(np.int32)
        fork_cond = packed[base + n:base + 2 * n].astype(np.int32)
        if shard_words is not None:
            self._publish_shard(shard_words, status)
        if telemetry:
            self._publish_telemetry(packed[base + 3 * n:])
        return (*scalars, status, fork_cond)

    def _publish_telemetry(self, tel_words) -> None:
        """One chunk's telemetry words (cumulative device counters) into
        per-chunk deltas summed on the object (frontier.py:1365)."""
        tel_words = np.array(tel_words, dtype=np.int64)
        prev = self.tel_words
        if prev is None or prev.shape != tel_words.shape:
            prev = np.zeros_like(tel_words)
        delta = tel_words - prev
        self.tel_words = tel_words
        n_op, n_lc = symstep.N_OP_CLASSES, symstep.N_LIFECYCLE
        n_ec = symstep.N_ESC_CAUSES
        fixed = symstep.TELEMETRY_FIXED_WORDS
        self.op_hist += delta[:n_op]
        self.lifecycle += delta[n_op:n_op + n_lc]
        self.esc_cause += delta[n_op + n_lc:n_op + n_lc + n_ec]
        self.stack_hwm, self.esc_hwm = (int(v) for v in tel_words[fixed - 2:
                                                                  fixed])
        self.last_tag_delta = delta[fixed:fixed + len(self.tag_names)]
        self.tag_occupancy += self.last_tag_delta
        self.fleet_occupancy += delta[fixed + len(self.tag_names):]

    def _publish_shard(self, shard_words, status) -> None:
        """The summary's shard block (frontier.py:1481): per-shard tops and
        escape counts (read by the drains and the spill trigger), the
        steal counters as deltas against the last summary, and the load
        balance (imbalance, Jain fairness of running lanes plus pending
        rows per shard)."""
        block = np.array(shard_words, dtype=np.int64)
        d = self.n_shards
        tops, esc = block[:d], block[d:2 * d]
        sent, recv, moved = block[2 * d:3 * d], block[3 * d:4 * d], \
            int(block[4 * d])
        self.shard_tops, self.shard_esc = tops, esc
        prev = self.shard_steals
        self.shard_steals = (sent, recv, moved)
        if prev is None:
            prev = (np.zeros(d, dtype=np.int64), np.zeros(d, dtype=np.int64),
                    0)
        self.steals_sent += sent - prev[0]
        self.steals_received += recv - prev[1]
        self.steal_rows += moved - prev[2]
        running = (np.asarray(status) == RUNNING).reshape(d, -1).sum(1)
        load = running.astype(np.float64) + tops.astype(np.float64)
        square_sum = float(np.sum(load * load))
        self.shard_imbalance = int(load.max() - load.min())
        self.shard_fairness = (float(np.sum(load)) ** 2 / (d * square_sum)
                               if square_sum > 0 else 1.0)

    def _publish_merge(self, mstats: np.ndarray) -> None:
        """One merge pass's stats vector, decoded as `_publish_merge`
        (frontier.py:868) does: [merges, ites, mem_blends, blocked_by[5],
        tag_hits[K], depth_hist[6]]."""
        fixed = symstep.MERGE_STATS_FIXED
        merge_names = self.merge_names
        n_tags = len(merge_names)
        self.merge_passes += 1
        for label, count in zip(symstep.MERGE_BLOCKED_LABELS, mstats[3:8]):
            self.blocked_by[label] += int(count)
        merges = int(mstats[0])
        if not merges:
            return
        self.merges += merges
        self.merge_ites += int(mstats[1])
        self.mem_blends += int(mstats[2])
        tagged = 0
        for name, count in zip(merge_names, mstats[fixed:fixed + n_tags]):
            if count:
                tagged += int(count)
                self.tag_merges[name] = self.tag_merges.get(name, 0) \
                    + int(count)
        if merges > tagged:
            self.tag_merges["untagged"] = self.tag_merges.get(
                "untagged", 0) + merges - tagged
        for label, count in zip(symstep.MERGE_DEPTH_LABELS,
                                mstats[fixed + n_tags:]):
            self.ite_depth[label] += int(count)

    # -- row transfers ------------------------------------------------------------------

    def _index(self, values) -> torch.Tensor:
        return torch.from_numpy(np.asarray(values, dtype=np.int32)) \
            .to(self.device)

    def _pack_async(self, state_like, planes_like, index: torch.Tensor,
                    msize_m: int, sp_m: int, st_m: int, conds_m: int):
        """Launch the quantized pack and start its copy to the host; the
        handle unpacks later (`_pack_apply`)."""
        widths = pack_widths(state_like, planes_like, msize_m, sp_m, st_m,
                             conds_m)
        hosts, event = _device.start_host_copy(
            pack_rows(state_like, planes_like, index, *widths))
        return hosts, event, index.shape[0], widths

    @staticmethod
    def _pack_apply(handle):
        (i32, u8, gas), event, bucket, widths = handle
        _device.wait_host_copy(event)
        return drain_unpack(i32.numpy(), u8.numpy(), gas.numpy(), bucket,
                            *widths)

    def _fetch_rows(self, state_like, planes_like, index):
        """Maxima, then the pack, of the selected rows; the index is padded
        to a power of two by repeating index[0] (frontier.py:1659).
        Returns (rows_state, rows_planes, count)."""
        index = np.asarray(index)
        count = len(index)
        if not count:
            return None, None, 0
        padded = np.full(next_pow2(count), index[0], dtype=np.int32)
        padded[:count] = index
        padded = self._index(padded)
        maxima = row_maxima(state_like, planes_like, padded).cpu().numpy()
        rows_state, rows_planes = self._pack_apply(self._pack_async(
            state_like, planes_like, padded, *(int(v) for v in maxima)))
        return rows_state, rows_planes, count

    def _defer_lanes(self, state, planes, lanes) -> None:
        rows_state, rows_planes, count = self._fetch_rows(state, planes,
                                                          lanes)
        if count:
            self.deferred.append([rows_state, rows_planes, count, 0])

    def _spill_host(self, state, planes, status, lanes: List[int]) -> None:
        """Full rows of `lanes` to the host overflow tier (frontier.py:1726):
        one gather into a flat buffer and one copy of it to the host; the
        lanes go DEAD on the host."""
        index = np.asarray(lanes, dtype=np.int64)
        padded = np.full(next_pow2(len(index)), index[0], dtype=np.int64)
        padded[:len(index)] = index
        flat, slabs = gather_rows_flat(state, planes, self._index(padded))
        hosts, event = _device.start_host_copy([flat])
        _device.wait_host_copy(event)
        arrays = [view.numpy() for view in row_views(hosts[0], slabs)]
        n_state = len(StateBatch._fields)
        rows_state = {field: (array.view(np.uint32) if field in U32_FIELDS
                              else array)
                      for field, array in zip(StateBatch._fields, arrays)}
        rows_planes = dict(zip(SymPlanes._fields, arrays[n_state:]))
        for row in range(len(index)):
            self.pending.append((
                {field: rows_state[field][row] for field in rows_state},
                {field: rows_planes[field][row] for field in rows_planes}))
        status[index] = DEAD
        self.spilled += len(index)

    def _reseed_host(self, state, planes, status):
        """Pending rows into DEAD lanes, deepest first (fewest conditions
        last in a stable sort, popped from the end); each lane resumes with
        its row's own status (frontier.py:1750). The rows are laid out in
        one flat host buffer (pinned on the card), copied to the device at
        once and scattered from its leaf views."""
        count = min(int(np.sum(status == DEAD)), len(self.pending))
        if not count:
            return state, planes
        self.pending.sort(key=lambda rows: int(rows[1]["cond_count"]))
        take = [self.pending.pop() for _ in range(count)]
        lanes = np.nonzero(status == DEAD)[0][:count]
        bucket = next_pow2(count)
        index = np.full(bucket, self.n_lanes, dtype=np.int32)  # pad: drop
        index[:count] = lanes
        slabs, total = row_layout(list(state) + list(planes), bucket)
        host = torch.zeros(total, dtype=torch.uint8,
                           pin_memory=state.status.is_cuda)
        fields = [(0, field) for field in StateBatch._fields] \
            + [(1, field) for field in SymPlanes._fields]
        for (part, field), view in zip(fields, row_views(host, slabs)):
            rows = np.stack([entry[part][field] for entry in take])
            view.numpy().view(rows.dtype)[:count] = rows
        views = row_views(host.to(self.device, non_blocking=True), slabs)
        n_state = len(StateBatch._fields)
        state, planes = scatter_rows(
            state, planes, self._index(index),
            StateBatch(*views[:n_state]), SymPlanes(*views[n_state:]))
        for position, lane in enumerate(lanes):
            status[lane] = int(take[position][0]["status"])
        self.reseeded += count
        return state, planes

    def _fetch_escapes(self, sched, esc_count: int, esc_msize: int,
                       esc_sp: int, esc_slots: int, esc_conds: int,
                       arena_n: int, arena_nc: int):
        """Launch the pack of the buffered escape rows and the arena mirror
        delta and start both copies (frontier.py:1785); `_flush_backlog`
        lands them after the next chunk is queued. `run` flushes the last
        backlog before its blocking `_harena` refreshes and fetches after
        them, so a refresh never starts while two are in flight (the
        mirror's two staging slots)."""
        if self.harena is None:
            self.harena = A.HostArena(self.arena, 1, 0)  # empty mirror
        delta_handle = self.harena.refresh_async(self.arena, arena_n,
                                                 arena_nc)
        esc_cap = sched.esc_state.status.shape[0]
        # sharded: the used rows are each segment's prefix, counted by this
        # chunk's shard block
        if self.n_shards > 1 and self.shard_esc is not None:
            pool_used = pool_used_indices(self.shard_esc, esc_cap)
        else:
            pool_used = np.arange(min(esc_count, esc_cap))
        count = len(pool_used)
        bucket = min(next_pow2(max(count, 1)), esc_cap)
        index = np.zeros(bucket, dtype=np.int32)
        index[:min(count, bucket)] = pool_used[:bucket]
        pack_handle = self._pack_async(
            sched.esc_state, sched.esc_planes, self._index(index), esc_msize,
            esc_sp, esc_slots, esc_conds)
        return pack_handle, delta_handle, count

    def _flush_backlog(self, backlog) -> None:
        """Land a drain's copies: the mirror delta, then the rows, queued
        for lazy materialization."""
        if backlog is None:
            return
        pack_handle, delta_handle, count = backlog
        self.harena.refresh_apply(delta_handle)
        rows_state, rows_planes = self._pack_apply(pack_handle)
        self.deferred.append([rows_state, rows_planes, count, 0])

    # -- budget exhaustion --------------------------------------------------------------

    def hand_over(self, state: StateBatch, planes: SymPlanes,
                  sched: Optional[symstep.DeviceScheduler] = None) -> None:
        """Pack what the host continues with into `deferred`: live lanes
        (running, forking, frozen escaped), the used stack and escape pool
        rows, then the host overflow rows (frontier.py:2378-2435, rows
        packed instead of materialized)."""
        status = state.status.cpu().numpy()
        live = np.nonzero((status == RUNNING) | (status == FORKING)
                          | (status == ESCAPED))[0]
        pools = []
        if sched is not None:
            pools = [(sched.stack_state, sched.stack_planes,
                      sched.stack_top.cpu().numpy()),
                     (sched.esc_state, sched.esc_planes,
                      sched.esc_count.cpu().numpy())]
        if not len(live) and not self.pending \
                and not any(np.sum(used) for _, _, used in pools):
            return
        self._harena()
        if len(live):
            self._defer_lanes(state, planes, live)
        for pool_state, pool_planes, used in pools:
            index = pool_used_indices(used, pool_state.status.shape[0])
            if len(index):
                self._defer_lanes(pool_state, pool_planes, index)
        for row_state, row_planes in self.pending:
            self.deferred.append([
                {field: value[None] for field, value in row_state.items()},
                {field: value[None] for field, value in row_planes.items()},
                1, 0])
        del self.pending[:]
