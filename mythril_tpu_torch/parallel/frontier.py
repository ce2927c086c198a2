"""The frontier's drain loop, device half (port of
mythril_tpu/parallel/frontier.py:66-248, 706-747, 914-989, 1068-1363,
1616-1848, 2378-2435).

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
  5. reseeds host overflow rows into DEAD lanes once the stack is empty.

The device programs between chunks are kernels on CUDA tensors and plain
PyTorch twins (`*_reference`) on CPU tensors:

  K5 `summary`                          kernels/frontier_summary.cu
  K6 `row_maxima`, `pack_rows`, `reset_esc`  kernels/pack_rows.cu
  K7 `gather_rows`, `scatter_rows`      kernels/gather_rows.cu
  K8 `arena.fetch_delta`                kernels/arena_delta.cu

What the host does with the drained rows (materializing GlobalStates,
cold-SLOAD fault-ins) needs the host engine, which is not ported: drained
rows wait in `deferred` as [rows_state, rows_planes, count, cursor] blocks,
and a cold-SLOAD pause goes to a caller-given `service_cold` hook. State
merging, telemetry, work stealing, fleets and checkpoints are not ported;
this driver runs the configuration with all of them off, on one shard."""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as _device
from . import arena as A
from . import symstep, words
from .batch import (DEAD, ESCAPED, FORKING, RUNNING, U32_FIELDS, LaneSpec,
                    StateBatch, build_batch, next_pow2, to_tensor)
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

#: words of the summary before its per-lane blocks
SUMMARY_SCALARS = 13

#: int32 section of a packed row block, one word per row each, in order
_DRAIN_I32_FIELDS = ("pc", "sp", "msize", "code_len", "cond_count",
                     "ctx_id", "last_jump", "branches")
_PLANE_FIELDS = frozenset(("cond_count", "ctx_id", "last_jump", "branches"))


# ---- the device programs (twins) ------------------------------------------------------

def summary_reference(state: StateBatch, planes: SymPlanes, arena: A.Arena,
                      sched: symstep.DeviceScheduler) -> torch.Tensor:
    """Plain twin of kernel K5 (`_summary`, frontier.py:99): int64[13 + 3B]
    = [stack_top, esc_count, executed, forks, pushes, pops, arena_n,
    arena_n_const, esc_msize_max, esc_sp_max, esc_slots_max,
    esc_conds_max, batch] + status[B] + fork_cond[B] + ctx_id[B]. Maxima
    run over the live escape rows (row < esc_count), 0 when none is."""
    symstep._check_scheduler(sched)
    esc_rows = sched.esc_state.status.shape[0]
    live = torch.arange(esc_rows, device=state.status.device) \
        < sched.esc_count.to(I64)

    def live_max(column):
        return torch.where(live, column.to(I64), 0).max()

    batch = state.status.shape[0]
    scalars = torch.stack([
        sched.stack_top.to(I64), sched.esc_count.to(I64),
        sched.executed, sched.forks, sched.pushes, sched.pops,
        arena.n.to(I64), arena.n_const.to(I64),
        live_max(sched.esc_state.msize), live_max(sched.esc_state.sp),
        live_max(sched.esc_state.storage_used.sum(1, dtype=I32)),
        live_max(sched.esc_planes.cond_count),
        torch.tensor(batch, dtype=I64, device=state.status.device)])
    return torch.cat([scalars, state.status.to(I64),
                      planes.fork_cond.to(I64), planes.ctx_id.to(I64)])


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
    escape count goes to 0, in place."""
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


# ---- dispatch: the kernel on CUDA tensors, the twin on the CPU ----------------------

def summary(state, planes, arena, sched) -> torch.Tensor:
    """The chunk summary: kernel K5 on CUDA tensors, the twin on the CPU."""
    if state.status.is_cuda:
        symstep._check_scheduler(sched)
        from ..kernels import ops

        return ops.frontier_summary(state, planes, arena, sched)
    return summary_reference(state, planes, arena, sched)


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


def gather_rows(state, planes, index):
    """Row gather: kernel K7 on CUDA tensors, the twin on the CPU."""
    if state.status.is_cuda:
        from ..kernels import ops

        return ops.gather_rows(state, planes, index)
    return gather_rows_reference(state, planes, index)


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


def _rows_to_numpy(rows_state: StateBatch, rows_planes: SymPlanes):
    """Full row blocks -> ({field: numpy}, {field: numpy}) in the JAX
    package's dtypes, with one wait for all the copies."""
    hosts, event = _device.start_host_copy(list(rows_state)
                                           + list(rows_planes))
    _device.wait_host_copy(event)
    arrays = [host.numpy() for host in hosts]
    n_state = len(StateBatch._fields)
    state_np = {field: (array.view(np.uint32) if field in U32_FIELDS
                        else array)
                for field, array in zip(StateBatch._fields, arrays)}
    planes_np = dict(zip(SymPlanes._fields, arrays[n_state:]))
    return state_np, planes_np


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


# ---- the driver ---------------------------------------------------------------------

#: (code, concrete storage {key: value}, storage base symbolic, gas limit,
#: address) of one seed
Seed = Tuple[bytes, Dict[int, int], bool, int, int]

#: service_cold(frontier, state, planes, status, lanes) -> (state, planes):
#: fault the lanes' cold storage slots in, setting status[lane] on the host
ColdService = Callable[..., Tuple[StateBatch, SymPlanes]]


class DeviceFrontier:
    """The device half of `_Frontier` (frontier.py:558): seeding, scheduler
    sizing, the chunk loop with its drains, and the hand-over of what is
    left when the budget runs out. Settings are the JAX knobs' defaults:
    `stack_bytes`/`esc_bytes` MYTHRIL_TPU_STACK_BYTES/ESC_BYTES,
    `drain_batch` MYTHRIL_TPU_DRAIN_BATCH (None: max(4 lanes, 1024)),
    `chunk` and `max_steps` MYTHRIL_TPU_CHUNK/MAX_STEPS."""

    def __init__(self, n_lanes: int = DEFAULT_LANES, device=None,
                 chunk: int = CHUNK, max_steps: int = MAX_STEPS,
                 stack_bytes: int = 3 << 30, esc_bytes: int = 1 << 30,
                 drain_batch: Optional[int] = None,
                 arena: Optional[A.Arena] = None,
                 service_cold: Optional[ColdService] = None):
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

    # -- seeding ------------------------------------------------------------------------

    def seed(self, seeds: Sequence[Seed]) -> Tuple[StateBatch, SymPlanes]:
        """One RUNNING lane per seed (identity placement, symbolic env),
        DEAD fillers elsewhere; `ctx_id` is the seed's index
        (frontier.py:914-989 without host terms)."""
        if len(seeds) > self.n_lanes:
            raise ValueError(f"{len(seeds)} seeds for {self.n_lanes} lanes")
        specs = [LaneSpec(code=code, storage=storage, gas_limit=gas_limit,
                          address=address)
                 for code, storage, _base, gas_limit, address in seeds]
        specs += [LaneSpec(code=b"\x00")] * (self.n_lanes - len(seeds))
        state = build_batch(specs, device=self.device)
        planes = SymPlanes.empty(self.n_lanes, state.stack.shape[1],
                                 state.memory.shape[1],
                                 state.storage_keys.shape[1], MAX_CONDS,
                                 device=self.device)
        n = len(seeds)
        state.status.fill_(DEAD)
        state.status[:n] = RUNNING
        planes.storage_base_sym[:n] = torch.tensor(
            [bool(seed[2]) for seed in seeds], dtype=torch.bool)
        planes.ctx_id[:n] = torch.arange(n, dtype=I32)
        return state, planes

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
        self.row_bytes = row_bytes
        return symstep.new_scheduler(state, planes, stack_rows, esc_rows)

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
        (frontier.py:1068-1363 with merge, steal, telemetry, fleet and
        checkpoints off). What is left goes to `deferred` (`hand_over`)."""
        chunk = self.chunk
        headroom = max(ARENA_HEADROOM, 4 * chunk * self.n_lanes)
        if headroom > self.arena.capacity // 2:
            self.hand_over(state, planes)
            return
        sched = self.new_sched(state, planes)
        stack_rows = sched.stack_state.status.shape[0]
        drain_batch = min(self.drain_batch, sched.esc_state.status.shape[0])
        lane_base, fork_base = self.lane_steps, self.forks
        push_base, pop_base = self.stack_pushes, self.stack_pops
        steps = 0
        n = self.n_lanes
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
            # the chunk is queued: land the previous drain while it runs
            if backlog is not None:
                self._flush_backlog(backlog)
                backlog = None
            packed = summary(state, planes, self.arena, sched).cpu().numpy()
            (stack_top, esc_count, executed, forks, pushes, pops, arena_n,
             arena_nc, esc_msize, esc_sp, esc_slots, esc_conds, _batch) = (
                 int(v) for v in packed[:SUMMARY_SCALARS])
            base = SUMMARY_SCALARS
            status = packed[base:base + n].astype(np.int32)
            fork_cond = packed[base + n:base + 2 * n].astype(np.int32)
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
                        "cold-SLOAD service needs the host engine "
                        "(ROADMAP A 6b/7)")
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
            if waiting.any() and not (status == RUNNING).any() \
                    and not (status == DEAD).any() \
                    and stack_top >= stack_rows:
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
            if not ((status == RUNNING) | (status == FORKING)).any() \
                    and stack_top == 0 and esc_count == 0 \
                    and not self.pending:
                self._flush_backlog(backlog)
                return
        self._flush_backlog(backlog)
        self.hand_over(state, planes, sched)

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
        """Full rows of `lanes` to the host overflow tier (frontier.py:1726);
        the lanes go DEAD on the host."""
        index = np.asarray(lanes, dtype=np.int64)
        padded = np.full(next_pow2(len(index)), index[0], dtype=np.int64)
        padded[:len(index)] = index
        rows_state, rows_planes = _rows_to_numpy(
            *gather_rows(state, planes, self._index(padded)))
        for row in range(len(index)):
            self.pending.append((
                {field: rows_state[field][row] for field in rows_state},
                {field: rows_planes[field][row] for field in rows_planes}))
        status[index] = DEAD
        self.spilled += len(index)

    def _reseed_host(self, state, planes, status):
        """Pending rows into DEAD lanes, deepest first (fewest conditions
        last in a stable sort, popped from the end); each lane resumes with
        its row's own status (frontier.py:1750)."""
        count = min(int(np.sum(status == DEAD)), len(self.pending))
        if not count:
            return state, planes
        self.pending.sort(key=lambda rows: int(rows[1]["cond_count"]))
        take = [self.pending.pop() for _ in range(count)]
        lanes = np.nonzero(status == DEAD)[0][:count]
        bucket = next_pow2(count)
        index = np.full(bucket, self.n_lanes, dtype=np.int32)  # pad: drop
        index[:count] = lanes

        def block(fields, part):
            out = []
            for field in fields:
                rows = np.stack([entry[part][field] for entry in take])
                if bucket != count:
                    rows = np.concatenate([rows, np.zeros(
                        (bucket - count,) + rows.shape[1:], dtype=rows.dtype)])
                out.append(to_tensor(rows, self.device))
            return out

        state, planes = scatter_rows(
            state, planes, self._index(index),
            StateBatch(*block(StateBatch._fields, 0)),
            SymPlanes(*block(SymPlanes._fields, 1)))
        for position, lane in enumerate(lanes):
            status[lane] = int(take[position][0]["status"])
        self.reseeded += count
        return state, planes

    def _fetch_escapes(self, sched, esc_count: int, esc_msize: int,
                       esc_sp: int, esc_slots: int, esc_conds: int,
                       arena_n: int, arena_nc: int):
        """Launch the pack of the buffered escape rows and the arena mirror
        delta and start both copies (frontier.py:1785); `_flush_backlog`
        lands them after the next chunk is queued."""
        if self.harena is None:
            self.harena = A.HostArena(self.arena, 1, 0)  # empty mirror
        delta_handle = self.harena.refresh_async(self.arena, arena_n,
                                                 arena_nc)
        esc_cap = sched.esc_state.status.shape[0]
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
                      int(sched.stack_top)),
                     (sched.esc_state, sched.esc_planes,
                      int(sched.esc_count))]
        if not len(live) and not self.pending \
                and not any(used for _, _, used in pools):
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
