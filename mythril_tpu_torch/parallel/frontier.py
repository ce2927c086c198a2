"""The frontier driver (port of mythril_tpu/parallel/frontier.py:66-2605;
the fleet driver that packs several contracts into one frontier is
`parallel/fleet.py`).

`DeviceFrontier.run` loops `symstep.run_chunk` and, between chunks, does what
the JAX driver does with the device's output:

  1. reads ONE packed summary vector (scheduler scalars, escape-row maxima,
     lane status, fork condition, context id) — the chunk's only blocking
     read besides what a drain needs;
  2. hands cold-SLOAD pauses to its `service_cold` hook;
  3. packs lanes frozen ESCAPED (escape buffer full) off to the deferred
     queue and frees them;
  4. spills half the waiting forkers to the host overflow tier when the
     frontier deadlocks with the sibling stack full;
  5. bulk-drains the escape buffer into packed host rows and mirrors the
     new arena rows, both copied to the host while the next chunk runs;
  6. reseeds host overflow rows into DEAD lanes once the stack is empty;
  7. decodes the telemetry words at the summary's end into per-chunk
     deltas, and runs a merge pass (`symstep.merge_pass`) when the merge
     tags' occupancy or the chunk cadence says so;
  8. with a `checkpoint_path`, every 16 chunks saves the device phase as
     one .npz (`save_checkpoint`: the trees, the arena's used prefix, the
     counters, the scheduler's rows as pending rows, the host terms), in
     the JAX package's key names and dtypes, so either package's
     `load_checkpoint` continues the other's drive; a drive that ends
     deletes it.

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

`Frontier`, the single-contract driver's host half, extends it: it seeds
from the host engine's GlobalStates (`build_seed_templates`; symbolic
storage values become host-term leaves, one standalone K3 allocation
each), serves cold-SLOAD pauses (one K7 gather, host fault-ins of
Select(base, key), one K7 scatter), materializes drained rows into the
laser's worklist (`make_feeder`, lazily, as the host's exec loop asks),
and runs under the host's execution budget, dropping what is left when it
is spent. Beside the laser's host checkpoint it saves the device phase to
`<checkpoint>.device.npz` (after materializing the deferred rows into the
worklist, which the host pickle owns) and resumes from
`<resume>.device.npz`. `execute_message_call_tpu` is what `core/svm.py`
calls for each message-call transaction under `engine="tpu"`;
`configure` sets its lanes, chunk, step budget, escape-time pruning,
host-drain skip and device (the card unless a test names the CPU). The
static tables that tag merge points and bound the widened memory merge
are built by the port's static analysis (`static_tables`, from
`staticanalysis/` through `smt/solver/cfa_screen.py` and
`analysis/module_screen.py`) when `seed` sees the codes, unless the
caller hands them in. `configure(fleet_shard=D)` splits every frontier
it builds into D logical shards (with `steal_cadence` and
`steal_min_imbalance`), as MYTHRIL_TPU_FLEET_SHARD does the JAX
frontier's. A fleet (`parallel/fleet.py` `FleetDriver`) seeds one
`Frontier` with several contracts' seeds and their members: the contexts
carry each member and its laser, the occupancy telemetry gets a slot a
member, the chunk loop calls the driver's deadline drain, rows of a
drained member are dropped and counted on its own laser, solver calls
run in the owning member's symbol namespace, and rows materialize into
their own member's worklist. The device
checkpoint's paths come only from the laser's (the JAX package's
MYTHRIL_TPU_CHECKPOINT/_RESUME overrides are not carried), and a fleet
saves none."""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import sys
import time
import zipfile
from contextlib import nullcontext
from copy import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from ..analysis import module_screen
from . import convert
from ..core.state.annotation import StateAnnotation
from ..frontends.disassembler import Disassembly
from ..smt.solver import cfa_screen
from . import arena as A
from . import symstep, words
from .batch import (DEAD, ESCAPED, FORKING, RUNNING, U32_FIELDS, LaneSpec,
                    StateBatch, build_batch, next_pow2, row_layout,
                    row_views, shard_count)
from .symstep import SymPlanes

log = logging.getLogger(__name__)

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
#: share of the execution budget left at its start that the single-contract
#: driver's device phase may take; the rest is the host continuation's
#: (MYTHRIL_TPU_DEVICE_FRAC's default)
DEVICE_FRAC = 0.85
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

#: the arena's per-node columns, in the checkpoint's order
ARENA_COLUMNS = ("op", "a", "b", "c", "imm", "imm2", "cls")
#: file-level errors of a device checkpoint that degrade a resume to a
#: fresh device phase (a corrupt, truncated or foreign file)
CHECKPOINT_ERRORS = (ValueError, KeyError, OSError, EOFError,
                     pickle.UnpicklingError, zipfile.BadZipFile)

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
    `_collect_fleet_slots` (frontier.py:787). With `fleet` set (a
    `FleetDriver`), each chunk's summary goes through its
    `deadline_drain(frontier, status, lane_ctx)`, which may kill lanes
    in place (frontier.py:1235-1240)."""

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
        #: the fleet driver whose deadline drain runs after each summary
        self.fleet = None
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
        #: seeding contexts (the single-contract driver's) and the laser
        #: that owns them, which a checkpoint names; none here
        self.contexts: list = []
        self.laser = None
        #: the device checkpoint `run` saves every 16 chunks (None: none)
        self.checkpoint_path: Optional[str] = None

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
        (frontier.py:1068-1363). What is
        left goes to `deferred` (`hand_over`). With a `checkpoint_path` the
        drive is saved every 16 chunks and the file deleted at its end."""
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
            if self.out_of_time(phase_start, deadline_s):
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
             fork_cond, lane_ctx) = self._decode_summary(
                 packed, sched.telemetry is not None)
            self.lane_steps = lane_base + executed
            self.forks = fork_base + forks
            self.stack_pushes = push_base + pushes
            self.stack_pops = pop_base + pops
            dirty = False
            # a fleet member past its budget has its live lanes killed in
            # place, freed for the others: not a global abort
            if self.fleet is not None \
                    and self.fleet.deadline_drain(self, status, lane_ctx):
                dirty = True
            # cold-SLOAD pauses need a host fault-in to progress at all
            cold = np.nonzero((status == FORKING) & (fork_cond == 0))[0]
            if len(cold):
                if self.service_cold is None:
                    raise NotImplementedError(
                        "a cold-SLOAD pause needs a service_cold hook "
                        "(the single-contract driver's is "
                        "Frontier._service_cold)")
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
            if self.checkpoint_path and steps % (chunk * 16) == 0:
                self.periodic_checkpoint(state, planes, sched)
            if not ((status == RUNNING) | (status == FORKING)).any() \
                    and stack_top == 0 and esc_count == 0 \
                    and not self.pending:
                self._flush_backlog(backlog)
                self._discard_checkpoint(self.checkpoint_path)
                return
        self.finish(state, planes, sched, backlog)
        self._discard_checkpoint(self.checkpoint_path)

    def out_of_time(self, phase_start: float,
                    deadline_s: Optional[float]) -> bool:
        """Whether the device phase ends before the next chunk: `deadline_s`
        seconds after `phase_start` (time.monotonic)."""
        return deadline_s is not None \
            and time.monotonic() - phase_start > deadline_s

    def finish(self, state: StateBatch, planes: SymPlanes,
               sched: symstep.DeviceScheduler, backlog) -> None:
        """The budget ran out with the tree not drained: land the last
        drain, then `hand_over` what is left."""
        self._flush_backlog(backlog)
        self.hand_over(state, planes, sched)

    # -- summary, telemetry and merge decoding ----------------------------------------

    def _decode_summary(self, packed: np.ndarray, telemetry: bool) -> tuple:
        """One chunk's summary vector: its shard block and its telemetry
        words published (copied, so that the caller may reuse `packed`);
        returns the twelve scalars the loop reads, then status, fork_cond
        and each lane's context id as new int32 arrays."""
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
        lane_ctx = packed[base + 2 * n:base + 3 * n].astype(np.int32)
        if shard_words is not None:
            self._publish_shard(shard_words, status)
        if telemetry:
            self._publish_telemetry(packed[base + 3 * n:])
        return (*scalars, status, fork_cond, lane_ctx)

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

    def _gather_host(self, state, planes, lanes):
        """Full rows of `lanes` on the host: one K7 gather into a flat
        buffer (the index padded to a power of two with lanes[0]) and one
        copy of it. Returns (host buffer, slabs, state rows, plane rows),
        the rows numpy views of the buffer keyed by field, limbs as
        uint32."""
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
        return hosts[0], slabs, rows_state, rows_planes

    def _scatter_host(self, state, planes, host: torch.Tensor, slabs,
                      index: np.ndarray):
        """Row i of the flat host row block to lane index[i], in place: one
        copy to the device and one K7 scatter (indices outside the lanes
        are dropped)."""
        views = row_views(host.to(self.device, non_blocking=True), slabs)
        n_state = len(StateBatch._fields)
        return scatter_rows(state, planes, self._index(index),
                            StateBatch(*views[:n_state]),
                            SymPlanes(*views[n_state:]))

    def _spill_host(self, state, planes, status, lanes: List[int]) -> None:
        """Full rows of `lanes` to the host overflow tier (frontier.py:1726);
        the lanes go DEAD on the host."""
        index = np.asarray(lanes, dtype=np.int64)
        _, _, rows_state, rows_planes = self._gather_host(state, planes,
                                                          index)
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
        state, planes = self._scatter_host(state, planes, host, slabs, index)
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

    # -- checkpointing --------------------------------------------------------------

    def sched_rows(self, sched) -> List[Tuple[Dict[str, np.ndarray],
                                              Dict[str, np.ndarray]]]:
        """Full rows still held by the scheduler (sibling stack, then escape
        buffer), as pending rows in the JAX dtypes (frontier.py:1850):
        one K7 gather a pool. Read-only: the scheduler is not mutated."""
        rows = []
        for pool_state, pool_planes, counts in (
                (sched.stack_state, sched.stack_planes, sched.stack_top),
                (sched.esc_state, sched.esc_planes, sched.esc_count)):
            used = pool_used_indices(counts.cpu().numpy(),
                                     pool_state.status.shape[0])
            if not len(used):
                continue
            _, _, rows_state, rows_planes = self._gather_host(
                pool_state, pool_planes, used)
            for row in range(len(used)):
                rows.append((
                    {field: rows_state[field][row].copy()
                     for field in rows_state},
                    {field: rows_planes[field][row].copy()
                     for field in rows_planes}))
        return rows

    def checkpoint_arrays(self, state: StateBatch, planes: SymPlanes,
                          sched=None) -> Dict[str, np.ndarray]:
        """What `save_checkpoint` writes, keyed and typed as the JAX
        frontier's .npz (frontier.py:2214-2302): the trees, the arena's
        used prefix and capacities, the counters, the host overflow rows
        and the scheduler's rows as pending rows, the identity (lanes,
        contexts), the transaction index, and the contexts' host terms and
        contract ids pickled into uint8 arrays."""
        pending_rows = list(self.pending)
        if sched is not None:
            pending_rows += self.sched_rows(sched)
        arrays = {}
        for prefix, tree in (("state", state), ("planes", planes)):
            for field, leaf in zip(tree._fields, convert.to_numpy(tree)):
                arrays[f"{prefix}_{field}"] = leaf
        arena = convert.to_numpy(self.arena)
        used, used_const = int(arena.n), int(arena.n_const)
        for field in ARENA_COLUMNS:
            arrays[f"arena_{field}"] = getattr(arena, field)[:used]
        arrays["arena_const_vals"] = arena.const_vals[:used_const]
        arrays["arena_caps"] = np.asarray(
            [arena.op.shape[0], arena.const_vals.shape[0], used, used_const])
        arrays["counters"] = np.asarray(
            [self.forks, getattr(self, "infeasible", 0),
             getattr(self, "materialized", 0), self.lane_steps,
             self.spilled, self.reseeded])
        if pending_rows:
            for field in StateBatch._fields:
                arrays[f"pend_state_{field}"] = np.stack(
                    [rs[field] for rs, _ in pending_rows])
            for field in SymPlanes._fields:
                arrays[f"pend_planes_{field}"] = np.stack(
                    [rp[field] for _, rp in pending_rows])
        arrays["identity"] = np.asarray([self.n_lanes, len(self.contexts)])
        # a wave saved during an earlier transaction must not graft onto
        # this one's seeds (the lane and context counts alone would pass)
        arrays["tx_index"] = np.asarray(
            [int(getattr(self.laser, "_current_tx_index", 0))])
        # host-term leaves index into per-context lists that grow after
        # seeding (cold-SLOAD fault-ins): save the lists themselves
        limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(limit, 200_000))
        try:
            arrays["host_terms"] = np.frombuffer(
                pickle.dumps([ctx.host_terms for ctx in self.contexts]),
                dtype=np.uint8)
        finally:
            sys.setrecursionlimit(limit)
        arrays["contract_ids"] = np.frombuffer(
            pickle.dumps([ctx_contract_id(ctx) for ctx in self.contexts]),
            dtype=np.uint8)
        return arrays

    def save_checkpoint(self, path: str, state: StateBatch,
                        planes: SymPlanes, sched=None) -> str:
        """The device phase as one .npz (`checkpoint_arrays`), written
        crash-safe (tmp + fsync + os.replace). States already materialized
        onto the host worklist are the host checkpoint's. Returns the
        path written (".npz" appended when missing)."""
        from ..support.checkpoint import fsync_replace

        if not path.endswith(".npz"):
            path += ".npz"  # np.savez appends it; keep save/resume agreeing
        arrays = self.checkpoint_arrays(state, planes, sched)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as handle:
            np.savez_compressed(handle, **arrays)
        fsync_replace(tmp, path)
        return path

    def load_checkpoint(self, path: str) -> Tuple[StateBatch, SymPlanes]:
        """Restore (state, planes) saved by either package's
        `save_checkpoint` onto this frontier's device; the arena, counters,
        pending rows and host terms are restored in place, and the host
        mirror is dropped (the next `_harena` rebuilds it from row 0).
        Reads with allow_pickle=False; the host terms unpickle through the
        checkpoint module's port-only Unpickler. Raises ValueError on an
        identity mismatch (another seeding or transaction)."""
        from ..support.checkpoint import port_loads

        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as npz:
            data = {key: npz[key] for key in npz.files}
        n_lanes, n_contexts = (int(v) for v in data["identity"])
        if n_lanes != self.n_lanes or n_contexts != len(self.contexts):
            raise ValueError(
                f"checkpoint identity mismatch: saved {n_lanes} lanes / "
                f"{n_contexts} contexts, this frontier has {self.n_lanes} / "
                f"{len(self.contexts)}")
        if "tx_index" in data:
            saved_tx = int(data["tx_index"][0])
            current_tx = int(getattr(self.laser, "_current_tx_index", 0))
            if saved_tx != current_tx:
                raise ValueError(
                    f"checkpoint is for transaction {saved_tx}, the "
                    f"analysis is at transaction {current_tx}")
        if "contract_ids" in data:
            saved_ids = port_loads(data["contract_ids"].tobytes())
            current_ids = [ctx_contract_id(ctx) for ctx in self.contexts]
            if saved_ids != current_ids:
                raise ValueError(
                    f"checkpoint contract namespace mismatch: saved "
                    f"{saved_ids}, this seeding has {current_ids}")
        if "host_terms" not in data:
            raise ValueError("checkpoint predates host_terms serialization; "
                             "V_HOST_TERM leaves would resolve wrongly")
        for ctx, saved_terms in zip(
                self.contexts, port_loads(data["host_terms"].tobytes())):
            ctx.host_terms = saved_terms
        state = convert.from_numpy("state", StateBatch(
            **{f: data[f"state_{f}"] for f in StateBatch._fields}),
            self.device)
        planes = convert.from_numpy("planes", SymPlanes(
            **{f: data[f"planes_{f}"] for f in SymPlanes._fields}),
            self.device)
        cap, const_cap, used, used_const = (int(v)
                                            for v in data["arena_caps"])
        fields = {}
        for field in ARENA_COLUMNS:
            column = np.zeros(cap, dtype=np.int32)
            column[:used] = data[f"arena_{field}"]
            fields[field] = column
        const_vals = np.zeros((const_cap, words.NLIMBS), dtype=np.uint32)
        const_vals[:used_const] = data["arena_const_vals"]
        self.arena = convert.from_numpy("arena", A.Arena(
            n=np.int32(used), n_const=np.int32(used_const),
            const_vals=const_vals, **fields), self.device)
        self.harena = None  # a mirror of the replaced arena is invalid
        counters = [int(v) for v in data["counters"]]
        (self.forks, self.infeasible, self.materialized,
         self.lane_steps) = counters[:4]
        if len(counters) >= 6:
            self.spilled, self.reseeded = counters[4:6]
        self.pending = []
        if "pend_state_status" in data:
            for row in range(data["pend_state_status"].shape[0]):
                self.pending.append((
                    {field: data[f"pend_state_{field}"][row]
                     for field in StateBatch._fields},
                    {field: data[f"pend_planes_{field}"][row]
                     for field in SymPlanes._fields}))
        return state, planes

    def own_deferred(self) -> None:
        """Before a periodic save: hand the deferred rows to whoever the
        host checkpoint covers (the single-contract driver materializes
        them into the worklist); here no one does."""

    def periodic_checkpoint(self, state: StateBatch, planes: SymPlanes,
                            sched) -> None:
        """The drain loop's save every 16 chunks (frontier.py:1325-1351):
        the deferred rows first (`own_deferred`), then `save_checkpoint`.
        A save that fails on the file system or on pickling is logged and
        the drive goes on; any other error (a kernel's) propagates."""
        try:
            self.own_deferred()
            self.save_checkpoint(self.checkpoint_path, state, planes, sched)
        except (OSError, pickle.PicklingError, RecursionError) as error:
            log.warning("periodic device checkpoint failed (%s); "
                        "continuing without it", error)

    @staticmethod
    def _discard_checkpoint(checkpoint_path) -> None:
        """The device phase ended and its wave is fully on the host side:
        a leftover .npz would graft this wave onto a LATER transaction's
        fresh seeding on resume (same lane/context counts pass the
        identity check) — delete it (frontier.py:1533)."""
        if not checkpoint_path:
            return
        path = checkpoint_path if checkpoint_path.endswith(".npz") \
            else checkpoint_path + ".npz"
        try:
            if os.path.exists(path):
                os.remove(path)
        except OSError as error:
            log.warning("cannot remove completed device checkpoint %s: %s",
                        path, error)


# ---- the single-contract driver ---------------------------------------------------

#: the driver's settings (`configure`)
_settings: dict = {}


def configure(lanes: int = DEFAULT_LANES, chunk: int = CHUNK,
              max_steps: int = MAX_STEPS, check_escapes: bool = False,
              skip_host_drain: bool = False, device=None,
              fleet_shard: int = 0, fleet_lanes: int = 0,
              steal_cadence: int = STEAL_CADENCE,
              steal_min_imbalance: int = STEAL_MIN_IMBALANCE) -> None:
    """Set what `execute_message_call_tpu` and the fleet driver run with;
    what a call does not name takes its default, the JAX knob's
    (mythril_tpu/support/tpu_config.py:38-55, 117-143: MYTHRIL_TPU_LANES,
    CHUNK, MAX_STEPS, CHECK_ESCAPES, SKIP_HOST_DRAIN, FLEET_SHARD,
    FLEET_LANES, STEAL_CADENCE, STEAL_MIN_IMBALANCE). `device` None is the
    card; "cpu" runs the plain twins (tests). `fleet_shard` is every
    frontier's logical shard count, solo runs' too (0: the card count when
    there is more than one card, else 1; one that does not divide the
    lanes gives 1); `fleet_lanes` a fleet frontier's lanes (0: `lanes`)."""
    _settings.update(lanes=lanes, chunk=chunk, max_steps=max_steps,
                     check_escapes=check_escapes,
                     skip_host_drain=skip_host_drain, device=device,
                     fleet_shard=fleet_shard, fleet_lanes=fleet_lanes,
                     steal_cadence=steal_cadence,
                     steal_min_imbalance=steal_min_imbalance)


def reset() -> None:
    """Restore the default settings."""
    configure()


configure()


def resolve_device() -> torch.device:
    """The configured device (`device.resolve`: the card unless `configure`
    named the CPU; raises without a card)."""
    return _device.resolve(_settings["device"])


def new_frontier(laser_evm, n_lanes: int) -> "Frontier":
    """A `Frontier` of `n_lanes` lanes with the configured settings. The
    shard count is read as the JAX frontier reads MYTHRIL_TPU_FLEET_SHARD
    (frontier.py:668-680): 0 is the number of cards when the frontier
    runs on a card and there are more than one (`batch.shard_count`
    validates it against the lanes)."""
    setting = _settings
    n_shards = setting["fleet_shard"]
    if n_shards == 0 and resolve_device().type == "cuda" \
            and torch.cuda.device_count() > 1:
        n_shards = torch.cuda.device_count()
    return Frontier(laser_evm, n_lanes=n_lanes, device=setting["device"],
                    chunk=setting["chunk"], max_steps=setting["max_steps"],
                    check_escapes=setting["check_escapes"],
                    n_shards=n_shards,
                    steal_cadence=setting["steal_cadence"],
                    steal_min_imbalance=setting["steal_min_imbalance"])


class LaneContext(A.TxContext):
    """Seeding context: one (open world state, transaction) pair
    (frontier.py:482-491)."""

    def __init__(self, tx_id: str, calldata, environment, template):
        super().__init__(tx_id, calldata, environment)
        self.template = template


class MergeTagAnnotation(StateAnnotation):
    """Rides on materialized lanes whose basic block reconverges at a
    static post-dominator pc (frontier.py:494-505)."""

    __slots__ = ("merge_pc",)

    def __init__(self, merge_pc: int):
        self.merge_pc = merge_pc

    def __copy__(self):
        return MergeTagAnnotation(self.merge_pc)


def storage_entries(storage) -> Tuple[List[Tuple[int, object]], bool]:
    """`_storage_entries` (frontier.py:522-555): walk the storage store
    chain into ((concrete key, BitVec value) pairs, base is symbolic),
    latest store first. A symbolic key stops the walk there: the stores
    above it seed the table, and it and everything below become the
    symbolic base that cold SLOADs fault in from. A base other than the
    zero constant array is symbolic."""
    from ..smt import BitVec

    node = storage._standard_storage.raw
    entries: Dict[int, object] = {}
    while node.op == "store":
        key, value = node.args[1], node.args[2]
        if not key.is_const:
            return list(entries.items()), True
        entries.setdefault(key.value, BitVec(value))
        node = node.args[0]
    if node.op == "const_array":
        return list(entries.items()), not (node.args[0].is_const
                                           and node.args[0].value == 0)
    return list(entries.items()), True


def annotation_class_bits(value) -> int:
    """The arena class bits of a host term's detector annotations
    (frontier.py:1041-1052): origin or predictable taint carried through
    storage must still stop a dependent JUMPI on the device."""
    from ..analysis.modules.dependence_on_origin import OriginAnnotation
    from ..analysis.modules.dependence_on_predictable_vars import \
        PredictableValueAnnotation

    bits = 0
    for annotation in getattr(value, "annotations", ()):
        if isinstance(annotation, OriginAnnotation):
            bits |= 1 << A.V_ORIGIN
        elif isinstance(annotation, PredictableValueAnnotation):
            bits |= 1 << A.V_TIMESTAMP
    return bits


class Frontier(DeviceFrontier):
    """The host half of `_Frontier` (frontier.py:558-2435) over the device
    half: seeding from host GlobalStates with symbolic storage values as
    host-term leaves, the cold-SLOAD fault-in service, materialization of
    drained rows into the laser's worklist, the execution budget and the
    hand-over. Telemetry and state merging follow the port's `args`
    (`--no-frontier-telemetry`, `--no-state-merge`), the window table
    `cfa_screen.absint_enabled()`, as the JAX frontier reads them.

    A fleet's frontier (the driver sets `fleet` and `seed_owner_index`
    and seeds it with the members) is the JAX `_Frontier` in fleet mode:
    see the module's docstring."""

    def __init__(self, laser_evm, n_lanes: int = DEFAULT_LANES, device=None,
                 chunk: int = CHUNK, max_steps: int = MAX_STEPS,
                 check_escapes: bool = False, n_shards: int = 1,
                 steal_cadence: int = STEAL_CADENCE,
                 steal_min_imbalance: int = STEAL_MIN_IMBALANCE):
        from ..support.support_args import args

        super().__init__(
            n_lanes, device=device, chunk=chunk, max_steps=max_steps,
            service_cold=type(self)._service_cold,
            telemetry=getattr(args, "frontier_telemetry", True),
            state_merge=getattr(args, "state_merge", True),
            n_shards=n_shards, steal_cadence=steal_cadence,
            steal_min_imbalance=steal_min_imbalance)
        self.laser = laser_evm
        #: escape-time pruning (MYTHRIL_TPU_CHECK_ESCAPES), off by default:
        #: the host engine's JUMPI is optimistic, so feasibility is decided
        #: where the host decides it, at issue time
        self.check_escapes = check_escapes
        self.contexts: List[LaneContext] = []
        self.materialized = 0
        self.infeasible = 0
        self.faults = 0  # cold-SLOAD fault-ins serviced
        #: (signed cond id, ctx index) -> Bool (see _cond_bools)
        self._cond_memo: Dict[Tuple[int, int], object] = {}
        #: a fleet: id(member) -> the indices of its seeding contexts
        self.fleet_ctx_of: Dict[int, List[int]] = {}

    # -- seeding ------------------------------------------------------------------------

    def seed(self, templates, members=None) -> Tuple[StateBatch, SymPlanes]:
        """One lane per template (frontier.py:914-989): its code, concrete
        storage table, symbolic base, gas limit and address; symbolic
        storage values enter as host-term leaves in `storage_sym`. A
        fleet hands in each template's member (frontier.py:2945-2951):
        its context carries the member and the member's laser, and the
        occupancy telemetry gets a slot a member
        (`_collect_fleet_slots`)."""
        specs = []
        for template in templates:
            entries, base_sym = storage_entries(
                template.environment.active_account.storage)
            code_hex = template.environment.code.bytecode
            code = bytes.fromhex(code_hex[2:] if code_hex.startswith("0x")
                                 else code_hex)
            # symbolic-valued slots enter the table with a 0 placeholder so
            # the slot exists; storage_sym overlays the leaf
            table = {key: (value.raw.value if value.raw.is_const else 0)
                     for key, value in entries}
            specs.append((template, entries, (
                code, table, base_sym, int(template.mstate.gas_limit),
                template.environment.address.raw.value)))
        state, planes = super().seed([spec for _, _, spec in specs])
        placed = []  # (lane, slot, node) of each host-term leaf
        for lane, (template, entries, _) in zip(
                self.assign_seed_lanes(len(specs)), specs):
            tx, _ = template.transaction_stack[-1]
            ctx = LaneContext(str(tx.id), template.environment.calldata,
                              template.environment, template)
            code = template.environment.code
            cfa_screen.warm(code)
            module_screen.warm(code)
            self.contexts.append(ctx)
            for key, value in entries:
                if value.raw.is_const:
                    continue
                node = self._alloc_host_term(ctx, value)
                if node is None:
                    continue
                slot = self._storage_slot_of(state, lane, key)
                if slot is not None:
                    placed.append((lane, slot, node))
        if placed:
            lanes, slots, nodes = (torch.tensor(column, device=self.device)
                                   for column in zip(*placed))
            planes.storage_sym[lanes, slots] = nodes.to(I32)
        if members is not None:
            for index, (ctx, member) in enumerate(zip(self.contexts,
                                                      members)):
                ctx.member = member
                ctx.laser = member.gate_laser
                self.fleet_ctx_of.setdefault(id(member), []).append(index)
        self.fleet_slots, self.fleet_names = self._collect_fleet_slots()
        self.fleet_occupancy = np.zeros(len(self.fleet_names),
                                        dtype=np.int64)
        return state, planes

    def _collect_fleet_slots(self) -> Tuple[List[int], List[str]]:
        """Each seeding context's occupancy slot, one a member's contract
        id, past TAG_SLOTS folded into the last (frontier.py:787-809);
        none outside a fleet."""
        if self.fleet is None:
            return [], []
        slots: List[int] = []
        names: List[str] = []
        index_of: Dict[str, int] = {}
        for ctx in self.contexts:
            member = getattr(ctx, "member", None)
            cid = member.contract_id if member is not None else "(unowned)"
            if cid not in index_of:
                if len(names) >= TAG_SLOTS:
                    log.info("frontier fleet telemetry: contract %r past "
                             "the %d-slot cap, folding into last slot",
                             cid, TAG_SLOTS)
                    slots.append(len(names) - 1)
                    continue
                index_of[cid] = len(names)
                names.append(cid)
            slots.append(index_of[cid])
        return slots, names

    def _alloc_host_term(self, ctx: LaneContext, value) -> Optional[int]:
        """Park a host BitVec as a V_HOST_TERM arena leaf (frontier.py:
        1016-1038): one K3 allocation, then the leaf's class bits widened by
        the term's detector annotations. None when the arena is full."""
        ctx.host_terms.append(value)
        want = torch.ones(1, dtype=torch.bool, device=self.device)
        _, node, overflow = A.alloc_rows(
            self.arena, want, A.VAR, 0, 0, 0, A.V_HOST_TERM,
            len(ctx.host_terms) - 1)
        node, overflow = (int(v) for v in torch.stack(
            [node[0], overflow[0].to(I32)]).cpu())
        if overflow:
            return None
        bits = annotation_class_bits(value)
        if bits:
            self.arena.cls[node:node + 1].bitwise_or_(bits)
        return node

    @staticmethod
    def _storage_slot_of(state: StateBatch, lane: int, key: int
                         ) -> Optional[int]:
        used = state.storage_used[lane].cpu().numpy()
        keys = state.storage_keys[lane].cpu().numpy()
        for slot in range(used.shape[0]):
            if used[slot] and int(words.to_ints(keys[slot])) == key:
                return slot
        return None

    # -- the budget -----------------------------------------------------------------------

    def run(self, state: StateBatch, planes: SymPlanes) -> None:
        """The drain loop under the execution budget (frontier.py:1154-1172):
        it ends when the host's budget has 1 s or less left, or after
        DEVICE_FRAC of the time left at its start. The laser's checkpoint
        path with a `.device` suffix is the drive's; its resume path's
        `.device.npz`, when there is one, replaces the seeded trees
        (frontier.py:1075-1105; consumed once, a file that does not load
        is logged and the seeds run). A fleet's frontier saves and loads
        none (frontier.py:1085-1092)."""
        from ..core.time_handler import time_handler

        host_ckpt = getattr(self.laser, "checkpoint_path", None)
        # not laser.resume_path: the host resume consumes that before the
        # frontier runs (svm.execute_transactions)
        host_resume = getattr(self.laser, "_device_resume_path", None)
        self.checkpoint_path = f"{host_ckpt}.device" if host_ckpt else None
        if self.fleet is not None and (host_ckpt or host_resume):
            # one npz under the primary member's name cannot hold a shared
            # wave: the members' own host checkpoints carry the resume
            log.info("fleet mode: device checkpoints disabled; per-contract "
                     "host checkpoints carry resume")
            self.checkpoint_path = host_resume = None
        if host_resume:
            resume_path = f"{host_resume}.device.npz"
            if os.path.exists(resume_path):
                try:
                    state, planes = self.load_checkpoint(resume_path)
                    log.info("resumed frontier from %s (%d forks so far)",
                             resume_path, self.forks)
                except CHECKPOINT_ERRORS as error:
                    log.warning("cannot resume from %s (%s); starting the "
                                "device phase fresh", resume_path, error)
                self.laser._device_resume_path = None
        super().run(state, planes,
                    time_handler.time_remaining() * DEVICE_FRAC / 1000)

    def own_deferred(self) -> None:
        """Deferred rows live only in host memory, which neither the .npz
        nor the host pickle covers: materialize them into the worklist, so
        the host checkpoint owns them (frontier.py:1326-1345). The cursor
        advances before a row is popped, so a failure leaves the rest to
        the feeder."""
        while self.deferred:
            entry = self.deferred[0]
            rows_state, rows_planes, count, _ = entry
            self._prefetch_feasibility(rows_planes, range(entry[3], count),
                                       state_np=rows_state)
            while entry[3] < count:
                row = entry[3]
                self._materialize_np(rows_state, rows_planes, self.harena,
                                     row)
                entry[3] = row + 1
            self.deferred.pop(0)

    def out_of_time(self, phase_start: float,
                    deadline_s: Optional[float]) -> bool:
        from ..core.time_handler import time_handler

        if time_handler.time_remaining() <= 1000:  # ms
            log.info("execution budget exhausted; ending device phase")
            return True
        if super().out_of_time(phase_start, deadline_s):
            log.info("device budget fraction (%.0f%%) consumed; the host "
                     "continuation takes over", DEVICE_FRAC * 100)
            return True
        return False

    def finish(self, state, planes, sched, backlog) -> None:
        """With no budget left the last drain is not landed: its rows drop
        like the host's mid-worklist states (frontier.py:1357-1363)."""
        from ..core.time_handler import time_handler

        if time_handler.time_remaining() > 1000:
            self._flush_backlog(backlog)
        self.hand_over(state, planes, sched)

    def hand_over(self, state: StateBatch, planes: SymPlanes,
                  sched: Optional[symstep.DeviceScheduler] = None) -> None:
        """`_hand_over_running` (frontier.py:2378-2435): with the budget
        spent, drop the live lanes and the backlog, marking the laser
        timed out (in a fleet, each row's own member's laser:
        `_drop_fleet_lanes`); else materialize the live lanes straight
        into the worklist, and defer the pools' used rows and the host
        overflow rows."""
        from ..core.time_handler import time_handler

        status = state.status.cpu().numpy()
        live = np.nonzero((status == RUNNING) | (status == FORKING)
                          | (status == ESCAPED))[0]
        pools = []
        if sched is not None:
            pools = [(sched.stack_state, sched.stack_planes,
                      sched.stack_top.cpu().numpy()),
                     (sched.esc_state, sched.esc_planes,
                      sched.esc_count.cpu().numpy())]
        backlog = len(self.pending) + sum(int(np.sum(used))
                                          for _, _, used in pools)
        if not len(live) and not backlog:
            return
        if time_handler.time_remaining() <= 1000:
            log.info("execution budget exhausted with %d live lanes + %d "
                     "backlog rows; dropping them (host-timeout parity)",
                     len(live), backlog)
            if self.fleet is not None:
                self._drop_fleet_lanes(planes, pools, live)
            else:
                self.laser.timed_out = True
                self.laser.dropped_states = getattr(
                    self.laser, "dropped_states", 0) + len(live) + backlog
            return
        harena = self._harena()
        if len(live):
            self._materialize_lanes(state, planes, harena, live)
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

    def _drop_fleet_lanes(self, planes: SymPlanes, pools, live) -> None:
        """The budget spent in a fleet: count every dropped lane, pool row
        and host overflow row on the laser of the member that owns it
        (frontier.py:2437-2461), so each partial report carries its own
        dropped states."""
        ctx_ids = [int(c) for c in planes.ctx_id.cpu().numpy()[live]]
        for _, pool_planes, used in pools:
            pool_ctx = pool_planes.ctx_id.cpu().numpy()
            ctx_ids += [int(c) for c in pool_ctx[pool_used_indices(
                used, len(pool_ctx))]]
        for _, row_planes in self.pending:
            ctx_ids.append(int(np.asarray(row_planes["ctx_id"]).flat[0]))
        for cid in ctx_ids:
            ctx = self.contexts[cid] if 0 <= cid < len(self.contexts) \
                else None
            member = getattr(ctx, "member", None) if ctx else None
            if member is not None:
                member.count_dropped(1)
            else:
                self.laser.timed_out = True
                self.laser.dropped_states = getattr(
                    self.laser, "dropped_states", 0) + 1

    # -- the cold-SLOAD service -----------------------------------------------------------

    def _service_cold(self, state: StateBatch, planes: SymPlanes, status,
                      cold: List[int]) -> Tuple[StateBatch, SymPlanes]:
        """Fault-in service for cold-SLOAD pauses (frontier.py:1881-1908):
        one K7 gather of the lanes' rows (padded to a power of two with
        index[0]) and its copy to the host, the fault-ins on the host rows,
        then one K7 scatter back (pad rows sent to the drop index)."""
        host, slabs, state_rows, planes_rows = self._gather_host(
            state, planes, cold)
        for row, lane in enumerate(cold):
            self._cold_sload_lane(state_rows, planes_rows, self.harena,
                                  status, int(lane), row)
        index = np.full(next_pow2(len(cold)), self.n_lanes,
                        dtype=np.int32)  # pad rows: dropped
        index[:len(cold)] = cold
        return self._scatter_host(state, planes, host, slabs, index)

    def _cold_sload_lane(self, state_np, planes_np, harena, status,
                         lane: int, row: int) -> None:
        """Fault one storage slot into a lane's table (frontier.py:
        1910-1955): the lane paused at an SLOAD whose concrete key misses
        the table on a symbolic base. The template's storage gives
        Select(base, key) or a known value, parked as a host-term leaf (a
        fault-in is a read: the slot stays clean), and the lane resumes. A
        full table or arena hands the lane to the host instead."""
        from ..smt import symbol_factory

        ctx = self.contexts[int(planes_np["ctx_id"][row])]
        sp = int(state_np["sp"][row])
        key = int(words.to_ints(state_np["stack"][row, sp - 1]))
        free = np.nonzero(~state_np["storage_used"][row])[0]
        if not len(free):
            self._materialize_np(state_np, planes_np, harena, row)
            status[lane] = DEAD
            return
        slot = int(free[0])
        account = ctx.template.environment.active_account
        value = account.storage[symbol_factory.BitVecVal(key, 256)]
        state_np["storage_keys"][row, slot] = words.from_int(key)
        state_np["storage_used"][row, slot] = True
        if value.raw.is_const:
            state_np["storage_vals"][row, slot] = words.from_int(
                value.raw.value)
            planes_np["storage_sym"][row, slot] = 0
        else:
            node = self._alloc_host_term(ctx, value)
            if node is None:
                # node 0 would read as concrete: the host takes the lane
                state_np["storage_used"][row, slot] = False
                self._materialize_np(state_np, planes_np, harena, row)
                status[lane] = DEAD
                return
            planes_np["storage_sym"][row, slot] = node
        planes_np["storage_dirty"][row, slot] = False
        self.faults += 1
        status[lane] = RUNNING

    # -- materialization ------------------------------------------------------------------

    def _cond_bools(self, planes_np, harena, lane: int) -> list:
        """Signed condition ids -> Bools, memoized per (id, context)
        (frontier.py:1957-1977): siblings share long condition prefixes."""
        from ..smt import Bool
        from ..smt import terms as T

        ctx_index = int(planes_np["ctx_id"][lane])
        ctx = self.contexts[ctx_index]
        memo = self._cond_memo
        bools = []
        for position in range(int(planes_np["cond_count"][lane])):
            signed = int(planes_np["conds"][lane, position])
            key = (signed, ctx_index)
            cached = memo.get(key)
            if cached is None:
                word = harena.to_term(abs(signed), ctx)
                is_zero = T.bv_cmp("eq", word.raw, T.bv_const(0, 256))
                cached = Bool(T.bool_not(is_zero) if signed > 0
                              else is_zero)
                memo[key] = cached
            bools.append(cached)
        return bools

    def _member_env(self, member):
        """`_member_env` (frontier.py:2607-2616): in a fleet, a solver call
        runs in `member`'s symbol namespace with its contract id as the
        dispatch's query origin; elsewhere a no-op."""
        if self.fleet is None or member is None:
            return nullcontext()
        return self.fleet.member_env(member)

    def _prefetch_feasibility(self, planes_np, rows, state_np=None) -> None:
        """With `check_escapes`, queue the feasibility queries of a slab of
        rows before they materialize one by one (frontier.py:1979-2036).
        In a fleet the rows go in groups by owning member, each built
        under `_member_env`, all on the one dispatch queue before any
        flush; a drained member's rows are skipped. Rows on a statically
        dead pc are skipped; a failure only means the rows solve one at a
        time."""
        if not self.check_escapes:
            return
        from ..core.state.constraints import Constraints
        from ..support.model import prefetch_models

        groups: List[Tuple[object, list]] = []
        by_member: Dict[int, list] = {}
        for row in rows:
            if int(planes_np["cond_count"][row]) <= 0:
                continue
            ctx = self.contexts[int(planes_np["ctx_id"][row])]
            member = getattr(ctx, "member", None)
            if member is not None and member.abandoned:
                continue  # deadline-drained: its rows never materialize
            if state_np is not None and cfa_screen.statically_dead(
                    ctx.template.environment.code, int(state_np["pc"][row])):
                continue
            key = id(member)
            if key not in by_member:
                by_member[key] = []
                groups.append((member, by_member[key]))
            by_member[key].append((ctx, row))
        for member, group_rows in groups:
            with self._member_env(member):
                sets = []
                for ctx, row in group_rows:
                    constraints = Constraints(
                        list(ctx.template.world_state.constraints)
                        + self._cond_bools(planes_np, self.harena, row))
                    sets.append(tuple(constraints.get_all_constraints()))
                try:
                    prefetch_models(sets)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as error:
                    log.debug("feasibility prefetch failed (%r); rows solve "
                              "individually", error)

    def _feasible(self, planes_np, harena, lane: int) -> bool:
        """A row's path conditions satisfiable (frontier.py:2038-2059), in
        its member's namespace in a fleet; a solver timeout or failure
        keeps the row."""
        from ..core.state.constraints import Constraints
        from ..exceptions import SolverTimeOutException, UnsatError
        from ..support.model import get_model

        ctx = self.contexts[int(planes_np["ctx_id"][lane])]
        with self._member_env(getattr(ctx, "member", None)):
            constraints = Constraints(
                list(ctx.template.world_state.constraints)
                + self._cond_bools(planes_np, harena, lane))
            try:
                get_model(tuple(constraints.get_all_constraints()))
                return True
            except SolverTimeOutException:
                return True  # a budget is not infeasibility
            except UnsatError:
                return False
            except Exception:
                return True

    def _materialize_np(self, state_np, planes_np, harena, lane: int) -> None:
        """One host row into a GlobalState of the template, appended to the
        laser's worklist (frontier.py:2063-2210): pc index (off the end is
        STOP), stack, the memory bytes that need a term, the dirty storage
        slots, path conditions, the integer detector's harvest, the last
        jump, merge and loop tags, gas and depth. In a fleet the state goes
        to its own member's laser, and a drained member's row is dropped
        and counted on it."""
        from ..smt import Extract, symbol_factory

        ctx = self.contexts[int(planes_np["ctx_id"][lane])]
        member = getattr(ctx, "member", None)
        if member is not None and member.abandoned:
            # the owning contract's budget is spent: its rows drop like
            # the host's mid-worklist states at a timeout
            member.count_dropped(1)
            return
        if self.check_escapes and int(planes_np["cond_count"][lane]) > 0 \
                and not self._feasible(planes_np, harena, lane):
            self.infeasible += 1
            return
        template = ctx.template
        global_state = copy(template)
        mstate = global_state.mstate

        byte_pc = int(state_np["pc"][lane])
        disassembly = global_state.environment.code
        index = disassembly.index_of_address(byte_pc)
        if index is None:
            if byte_pc >= int(state_np["code_len"][lane]):
                # off the code end: the host's fetch treats it as STOP
                index = len(disassembly.instruction_list)
            else:
                log.warning("materialize: pc %d not on an instruction "
                            "boundary", byte_pc)
                return
        mstate.pc = index

        sp = int(state_np["sp"][lane])
        mstate.stack.clear()
        for slot in range(sp):
            node = int(planes_np["stack_sym"][lane, slot])
            if node:
                mstate.stack.append(harena.to_term(node, ctx))
            else:
                value = int(words.to_ints(state_np["stack"][lane, slot]))
                mstate.stack.append(symbol_factory.BitVecVal(value, 256))

        # memory: only the bytes that need a term (symbolic markers and
        # nonzero concrete bytes)
        msize = int(state_np["msize"][lane])
        if msize:
            mstate.mem_extend(0, msize)
            mem = state_np["memory"][lane][:msize]
            mem_sym = planes_np["mem_sym"][lane][:msize]
            for offset in np.nonzero(mem_sym)[0]:
                marker = int(mem_sym[offset])
                node, byte_index = marker >> 5, marker & 31
                word = harena.to_term(node, ctx)
                high = 255 - 8 * byte_index
                mstate.memory[int(offset)] = Extract(high, high - 7, word)
            for offset in np.nonzero((mem_sym == 0) & (mem != 0))[0]:
                mstate.memory[int(offset)] = symbol_factory.BitVecVal(
                    int(mem[offset]), 8)

        # storage written on the device (dirty slots only: seeds and
        # fault-ins are in the template's storage already)
        account = global_state.environment.active_account
        used = state_np["storage_used"][lane]
        dirty = planes_np["storage_dirty"][lane]
        sink_values = []  # the integer detector's SSTORE/JUMPI sinks
        for slot in range(used.shape[0]):
            if not used[slot] or not dirty[slot]:
                continue
            key = int(words.to_ints(state_np["storage_keys"][lane, slot]))
            node = int(planes_np["storage_sym"][lane, slot])
            if node:
                value = harena.to_term(node, ctx)
                sink_values.append(value)
            else:
                value = symbol_factory.BitVecVal(
                    int(words.to_ints(state_np["storage_vals"][lane, slot])),
                    256)
            account.storage[symbol_factory.BitVecVal(key, 256)] = value

        for condition in self._cond_bools(planes_np, harena, lane):
            global_state.world_state.constraints.append(condition)
        for position in range(int(planes_np["cond_count"][lane])):
            signed = int(planes_np["conds"][lane, position])
            sink_values.append(harena.to_term(abs(signed), ctx))
        if sink_values:
            from ..analysis.modules.integer import harvest_values

            harvest_values(global_state, sink_values)

        # the exceptions detector keys its dedup cache on the last JUMP
        last_jump = int(planes_np["last_jump"][lane])
        if last_jump:
            from ..analysis.modules.exceptions import LastJumpAnnotation

            global_state.annotate(LastJumpAnnotation(last_jump))
        merge_pc = cfa_screen.merge_point_at(disassembly, byte_pc)
        if merge_pc is not None:
            global_state.annotate(MergeTagAnnotation(merge_pc))
        loop_header = module_screen.loop_header_at(disassembly, byte_pc)
        if loop_header is not None:
            global_state.annotate(LoopHintAnnotation(loop_header))

        # the device tracks the lower-bound gas model
        gas_used = int(state_np["gas_used"][lane])
        mstate.min_gas_used += gas_used
        mstate.max_gas_used += gas_used
        # depth parity: every JUMPI branch the device took
        mstate.depth += int(planes_np["branches"][lane])

        self.materialized += 1
        # fleet demux: a row re-enters its own contract's worklist
        laser = getattr(ctx, "laser", None) or self.laser
        if getattr(laser, "requires_statespace", False) and \
                global_state.node is None:
            global_state.node = template.node
        laser.work_list.append(global_state)

    def _materialize_lanes(self, state, planes, harena, lanes) -> None:
        """The lanes' rows (K6 maxima and pack, one copy) into the worklist
        (frontier.py:1681-1689)."""
        rows_state, rows_planes, count = self._fetch_rows(state, planes,
                                                          lanes)
        for row in range(count):
            self._materialize_np(rows_state, rows_planes, harena, row)

    def make_feeder(self, batch_rows: int = 256) -> Callable[[], bool]:
        """The svm exec loop's refill: materialize up to `batch_rows`
        deferred rows into the worklist; False when none is left
        (frontier.py:1827-1848)."""
        def feeder() -> bool:
            fed = 0
            while self.deferred and fed < batch_rows:
                entry = self.deferred[0]
                rows_state, rows_planes, count, cursor = entry
                take = min(count - cursor, batch_rows - fed)
                self._prefetch_feasibility(rows_planes,
                                           range(cursor, cursor + take),
                                           state_np=rows_state)
                for row in range(cursor, cursor + take):
                    self._materialize_np(rows_state, rows_planes,
                                         self.harena, row)
                entry[3] += take
                fed += take
                if entry[3] >= count:
                    self.deferred.pop(0)
            return fed > 0

        return feeder

    def undelivered(self) -> int:
        """Deferred rows not materialized yet."""
        return sum(entry[2] - entry[3] for entry in self.deferred)


def ctx_contract_id(ctx) -> str:
    """A seeding context's contract namespace, for checkpoint validation
    (frontier.py:2597-2604): its fleet member's id, else the active
    account's contract name."""
    member = getattr(ctx, "member", None)
    if member is not None:
        return member.contract_id
    account = ctx.template.environment.active_account
    return getattr(account, "contract_name", "") or ""


def build_seed_templates(laser_evm, callee_address,
                         func_hashes=None) -> list:
    """Consume the laser's open states into seed templates
    (frontier.py:2464-2514): one pending MessageCallTransaction GlobalState
    per open world state, with the ACTORS caller constraint and the
    selector restriction applied as on the host path."""
    from ..core.state.calldata import SymbolicCalldata
    from ..core.transaction.symbolic import (ACTORS,
                                             generate_function_constraints)
    from ..core.transaction.transaction_models import (
        MessageCallTransaction, get_next_transaction_id)
    from ..smt import Or, symbol_factory

    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    seeds = []
    for open_world_state in open_states:
        if open_world_state[callee_address].deleted:
            continue
        next_transaction_id = get_next_transaction_id()
        external_sender = symbol_factory.BitVecSym(
            f"sender_{next_transaction_id}", 256)
        calldata = SymbolicCalldata(next_transaction_id)
        transaction = MessageCallTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=symbol_factory.BitVecSym(
                f"gas_price{next_transaction_id}", 256),
            gas_limit=8000000,
            origin=external_sender,
            caller=external_sender,
            callee_account=open_world_state[callee_address],
            call_data=calldata,
            call_value=symbol_factory.BitVecSym(
                f"call_value{next_transaction_id}", 256),
        )
        template = transaction.initial_global_state()
        template.transaction_stack.append((transaction, None))
        template.world_state.constraints.append(
            Or(*[transaction.caller == actor
                 for actor in ACTORS.addresses.values()]))
        if func_hashes:
            for constraint in generate_function_constraints(calldata,
                                                            func_hashes):
                template.world_state.constraints.append(constraint)
        if getattr(laser_evm, "requires_statespace", False):
            laser_evm.new_node_for_transaction(template, transaction)
        seeds.append(template)
    return seeds


def execute_message_call_tpu(laser_evm, callee_address,
                             func_hashes=None) -> None:
    """`core/transaction/symbolic.py:execute_message_call` on the device
    (frontier.py:2517-2579): seed a frontier from every open state, explore
    on the device, then run the host continuation over the materialized
    and deferred rows, where the detectors run unchanged. Settings come
    from `configure`."""
    seeds = build_seed_templates(laser_evm, callee_address, func_hashes)
    if not seeds:
        laser_evm.exec()
        return
    setting = _settings
    frontier = new_frontier(laser_evm, max(setting["lanes"], 2 * len(seeds)))
    start = time.perf_counter()
    state, planes = frontier.seed(seeds)
    frontier.run(state, planes)
    device_s = time.perf_counter() - start
    log.info("frontier: %d forks, %d storage fault-ins, %d infeasible "
             "pruned, %d states materialized + %d deferred for the host "
             "(arena nodes: %d, stack pushes/pops %d/%d, host "
             "spills/reseeds %d/%d)",
             frontier.forks, frontier.faults, frontier.infeasible,
             frontier.materialized, frontier.undelivered(),
             int(frontier.arena.n), frontier.stack_pushes,
             frontier.stack_pops, frontier.spilled, frontier.reseeded)
    laser_evm.frontier_lane_steps = getattr(
        laser_evm, "frontier_lane_steps", 0) + frontier.lane_steps
    laser_evm.frontier_forks = getattr(
        laser_evm, "frontier_forks", 0) + frontier.forks
    if setting["skip_host_drain"]:
        # warm-up aid: the device phase without the host continuation
        del laser_evm.work_list[:]
        del frontier.deferred[:]
        return
    # deferred rows materialize lazily as the exec loop drains the
    # worklist: rows the budget never reaches cost nothing
    laser_evm.frontier_feeder = frontier.make_feeder()
    start = time.perf_counter()
    try:
        laser_evm.exec()
    finally:
        laser_evm.frontier_feeder = None
        dropped = frontier.undelivered()
        if dropped:
            log.info("execution budget exhausted with %d deferred frontier "
                     "rows unmaterialized; dropping them (host-timeout "
                     "parity)", dropped)
            laser_evm.timed_out = True
            laser_evm.dropped_states = getattr(
                laser_evm, "dropped_states", 0) + dropped
            del frontier.deferred[:]
        log.info("frontier phases: %d lanes, %d lane-steps in %d chunks, "
                 "device phase %.6f s, host continuation %.6f s",
                 frontier.n_lanes, frontier.lane_steps, frontier.chunks,
                 device_s, time.perf_counter() - start)
