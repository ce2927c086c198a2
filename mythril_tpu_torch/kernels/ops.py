"""Thin PyTorch wrappers around the hand-written CUDA kernels K1-K13.

Each wrapper checks device, dtype, shape and contiguity, allocates what the
kernel writes with `torch.empty`, fills the kernel's parameter block (slot
indices from layout.cuh), launches on the current device's current stream and
raises if the launch returned a CUDA error. Each adds one to its entry of
`LAUNCHES` where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernels.

  K1 keccak      kernels/keccak.cu       keccak.keccak256 (keccak.py:137)
  K2 evm_step    kernels/evm_step.cu     lockstep.step (lockstep.py:159)
  K3 arena_alloc kernels/arena_alloc.cu  arena.alloc_rows/alloc_consts
                                         (arena.py:105, 146)
  K4 sym_step    kernels/sym_step.cu     symstep.sym_step (symstep.py:347)
  K5 frontier_summary  kernels/frontier_summary.cu  frontier._summary
                                         (frontier.py:99)
  K6 pack_rows   kernels/pack_rows.cu    frontier._row_maxima, _pack_rows,
                                         _reset_esc (frontier.py:191, 156,
                                         248)
  K7 gather_rows kernels/gather_rows.cu  frontier._gather_rows,
                                         _scatter_rows (frontier.py:79, 88)
  K8 arena_delta kernels/arena_delta.cu  arena._fetch_delta (arena.py:185)
  K9 telemetry   kernels/sym_step.cu     the telemetry block of sym_step
                 (TEL instantiation)     (symstep.py:822-908, 359-360)
  K10 merge_pass kernels/merge_pass.cu   symstep.merge_pass (symstep.py:1057)
  K11 sat_step   kernels/sat_step.cu     jax_solver._step (jax_solver.py:247)
                                         under _get_runner (384) and
                                         _get_batch_runner (509)
  K12 steal_pass kernels/steal_pass.cu   frontier._steal_pass (frontier.py:319)
                                         with its codec (252, 267)
  K13 sat_shard_combine                  jax_solver._get_sharded_runner
                 kernels/sat_step.cu     (jax_solver.py:397): K11 over
                                         clause shards, combined a step

A count is per wrapper call: K4's call makes its launches of its own (K9
counts the calls that run its TEL instantiation) and runs the step's four
arena allocations inside them (`arena_alloc_step`, one a step); K10 counts
one per pass, whatever its rounds launch, and runs its blends' allocations
inside them (`arena_alloc_merge`, one a pass), so `arena_alloc` counts
standalone K3 calls only (the tests'); K1 counts its step form's launches
and its standalone calls; K6 counts its three entries together, K7 its
two. K11 counts one per chunk: its call runs every step of the chunk
(three launches a step, four with the batch runner's freeze gate, after
the chunk's mirror). A sharded chunk (`sat_run_sharded`) counts one for
K11 and one for K13's combine, whatever its shards and steps launch. K5
counts one per summary (the grid and its combining launch), K6's
`row_maxima` one per call (its grid and its combining launch). K12
counts one per pass (a plan launch and a move launch).

K2's (with K1's step form, eager or inside K4's step), K4's, K5's, K6's,
K7's, K10's, K11's and K12's parameter blocks and scratch are built once
for a set of tensors (keyed on their data pointers, shapes and dtypes,
and the few static arguments) and reused while the key holds; a call
with the very tensor objects of its cache's last call skips the key
(`_Plans`). K6's and K7's outputs are allocated a call (a K7 gather's
one flat buffer, whose leaf views it returns); K8 writes into its plan's
pinned staging, one plan an arena and mirror. A
chunk of K4 steps (`run_chunk_graph`), a chunk of K11 steps and a K13
chunk whose shards all lie on the caller's card are each captured as one
CUDA graph per key and replayed, adding the captured launches to
`LAUNCHES` on every replay; `REPLAYS` counts the replays and the captures
of each. A K10 pass is one eager host call.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import weakref
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from . import build, layout as Lay
from ..parallel.batch import row_layout, row_views
from ..parallel.device_solver import TILE
from ..parallel.symstep import (MAX_TEL_SLOTS, MERGE_STATS_FIXED,
                                N_MERGE_DEPTH, n_segments)

#: launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"keccak": 0, "evm_step": 0, "arena_alloc": 0,
                            "arena_alloc_step": 0, "arena_alloc_merge": 0,
                            "sym_step": 0,
                            "telemetry": 0,
                            "frontier_summary": 0, "pack_rows": 0,
                            "gather_rows": 0, "arena_delta": 0,
                            "merge_pass": 0, "sat_step": 0, "steal_pass": 0,
                            "sat_shard_combine": 0}

#: CUDA graph replays and captures since the last reset_launches(): of
#: `run_chunk_graph` (K4's chunks), of K11's chunks and of K13's one-card
#: chunks
REPLAYS: Dict[str, int] = {"run_chunk": 0, "captures": 0, "sat_chunk": 0,
                           "sat_captures": 0, "sat_shard_chunk": 0,
                           "sat_shard_captures": 0}

#: which source each exported entry point lives in
_ENTRY_LIB = {"mtpu_keccak_rows": "keccak", "mtpu_keccak_preload": "keccak",
              "mtpu_keccak_step": "keccak", "mtpu_keccak_step_grid": "keccak",
              "mtpu_evm_step": "evm_step",
              "mtpu_evm_step_grid": "evm_step", "mtpu_evm_preload": "evm_step", "mtpu_arena_alloc": "arena_alloc",
              "mtpu_sym_pre": "sym_step", "mtpu_sym_post": "sym_step",
              "mtpu_sym_pre_tel": "sym_step", "mtpu_sym_post_tel": "sym_step",
              "mtpu_sym_preload": "sym_step",
              "mtpu_frontier_summary": "frontier_summary",
              "mtpu_frontier_summary_grid": "frontier_summary",
              "mtpu_row_maxima": "pack_rows", "mtpu_pack_rows": "pack_rows",
              "mtpu_reset_esc": "pack_rows", "mtpu_pack_rows_grid": "pack_rows",
              "mtpu_gather_rows": "gather_rows",
              "mtpu_scatter_rows": "gather_rows",
              "mtpu_arena_delta": "arena_delta",
              "mtpu_arena_delta_map": "arena_delta",
              "mtpu_merge_pair": "merge_pass", "mtpu_merge_run": "merge_pass",
              "mtpu_sat_run": "sat_step", "mtpu_sat_preload": "sat_step",
              "mtpu_sat_shard_mirror": "sat_step",
              "mtpu_sat_shard_propagate": "sat_step",
              "mtpu_sat_shard_resolve": "sat_step",
              "mtpu_steal_pass": "steal_pass", "mtpu_steal_grid": "steal_pass"}
_FUNCS: Dict[str, object] = {}
_OPTABS: Dict[str, torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, REPLAYS):
        for name in counts:
            counts[name] = 0


def _entry(name: str):
    if name not in _FUNCS:
        fn = getattr(build.load(_ENTRY_LIB[name]), name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return _FUNCS[name]


def _block(name: str, values):
    """The ctypes parameter block of `values`."""
    if len(values) > Lay.MTPU_MAX_ARGS:
        raise ValueError(f"{name}: {len(values)} argument slots")
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])


def _raw_stream() -> int:
    """The current device's current stream, as a handle: without the Stream
    object that `torch.cuda.current_stream()` builds (several microseconds
    a call on the card's host, the most of a small kernel's wrapper)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _call(name: str, block, stream: Optional[int] = None) -> None:
    """Launch `name` on `stream` (a raw handle; the current stream when
    None) with its parameter block."""
    rc = _entry(name)(ctypes.cast(block, ctypes.c_void_p), len(block),
                      ctypes.c_void_p(_raw_stream() if stream is None
                                      else stream))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def _launch(name: str, values) -> None:
    _call(name, _block(name, values))


def _key(tensors, static: tuple) -> tuple:
    """A plan's key: every tensor's data pointer, shape and dtype, then the
    static arguments."""
    return tuple((t.data_ptr(), t.shape, t.dtype) for t in tensors) + static


class _Plans:
    """Plans (parameter blocks, scratch, captured graphs) built for sets of
    tensors and static arguments, filed under their `_key`: at most
    `limit`, the least recently used dropped. A call with the very tensor
    objects and static arguments of the last call takes that call's plan
    without building the key; the last call's tensors are held by weak
    reference, so that no tensor is kept alive (the port never points a
    tensor at other storage in place)."""

    def __init__(self, limit: int):
        self.limit = limit
        self.plans: OrderedDict = OrderedDict()
        self.last = None

    def get(self, tensors: list, static: tuple, build):
        """The plan of `tensors` and `static`, built on a miss."""
        last = self.last
        if last is not None and last[1] == static and len(last[0]) == len(tensors) \
                and all(ref() is t for ref, t in zip(last[0], tensors)):
            return last[2]
        key = _key(tensors, static)
        plan = self.plans.pop(key, None)
        if plan is None:
            plan = build()
        self.plans[key] = plan
        while len(self.plans) > self.limit:
            self.plans.popitem(last=False)
        self.last = ([weakref.ref(t) for t in tensors], static, plan)
        return plan

    def values(self):
        return self.plans.values()

    def clear(self) -> None:
        self.plans.clear()
        self.last = None


def _check(t: torch.Tensor, what: str, dtype, shape=None) -> int:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    return t.data_ptr()


def optab(device) -> torch.Tensor:
    """int32[256, 4] opcode table: pops, pushes, minimum gas, and flags
    (valid 1, host escape 2, symbolic-representable 4, plumbing 8, env var
    class << 8, telemetry op class << 16)."""
    key = str(device)
    if key not in _OPTABS:
        from ..parallel import lockstep, symstep

        table = np.zeros((256, 4), dtype=np.int32)
        table[:, 0] = lockstep.POPS
        table[:, 1] = lockstep.PUSHES
        table[:, 2] = lockstep.GAS_MIN
        table[:, 3] = (lockstep.VALID * 1 | lockstep.ESCAPE_OPS * 2
                       | symstep.SYM_OK * 4 | symstep.PLUMBING * 8
                       | symstep.ENV_CLASS << 8 | symstep.OP_CLASS << 16)
        _OPTABS[key] = torch.from_numpy(table).to(device)
    return _OPTABS[key]


# ---- K1 -----------------------------------------------------------------------------

@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def messages_a_warp(batch: int, device) -> int:
    """Messages a warp of the standalone K1 takes: one while the warps are
    fewer than the card's SMs, then doubled up to 32 as long as each SM
    keeps a warp (the host shim's CPU tensors count as 132 SMs)."""
    sms = _sm_count(device.index or 0) if device.type == "cuda" else 132
    per = 1
    while per < 32 and batch >= 2 * per * sms:
        per *= 2
    return per


def keccak_rows(data: torch.Tensor, length: torch.Tensor,
                offset: Optional[torch.Tensor] = None,
                limit: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: digest of row i of data[B, n] read from offset[i] (0 if absent)
    for length[i] bytes, bytes at or past limit[i] (n if absent) reading 0;
    rows whose mask is False get a zero digest. A warp hashes
    `messages_a_warp` of them."""
    batch, ncols = data.shape
    values = [0] * Lay.K1_NARGS
    values[Lay.K1_DATA] = _check(data, "data", torch.uint8)
    values[Lay.K1_STRIDE] = data.stride(0)
    values[Lay.K1_NCOLS] = ncols
    values[Lay.K1_LEN] = _check(length, "length", torch.int32, (batch,))
    if offset is not None:
        values[Lay.K1_OFFSET] = _check(offset, "offset", torch.int64, (batch,))
    if limit is not None:
        values[Lay.K1_LIMIT] = _check(limit, "limit", torch.int32, (batch,))
    if mask is not None:
        values[Lay.K1_MASK] = _check(mask, "mask", torch.bool, (batch,))
    out = torch.empty((batch, 32), dtype=torch.uint8, device=data.device)
    values[Lay.K1_OUT] = out.data_ptr()
    values[Lay.K1_BATCH] = batch
    values[Lay.K1_PER_WARP] = messages_a_warp(batch, data.device)
    _launch("mtpu_keccak_rows", values)
    LAUNCHES["keccak"] += 1
    return out


def keccak256(data: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """K1 on whole messages: data uint8[B, n], length int32[B]."""
    if int(data.shape[-1]) and bool((length > data.shape[-1]).any()):
        raise ValueError("length exceeds the message buffer")
    return keccak_rows(data, length)


# ---- K2 -----------------------------------------------------------------------------

def _state_dims(state) -> dict:
    batch, slots = state.stack.shape[0], state.stack.shape[1]
    return {"B": batch, "S": slots, "M": state.memory.shape[1],
            "C": state.code.shape[1], "D": state.calldata.shape[1],
            "R": state.retdata.shape[1], "K": state.storage_keys.shape[1],
            "T": state.tstore_keys.shape[1]}


_STATE_DTYPES = {"stack": torch.int32, "sp": torch.int32, "pc": torch.int32,
                 "gas_used": torch.int64, "gas_limit": torch.int64,
                 "status": torch.int32, "memory": torch.uint8,
                 "msize": torch.int32, "code": torch.uint8,
                 "code_len": torch.int32, "jumpdest": torch.bool,
                 "calldata": torch.uint8, "calldata_len": torch.int32,
                 "retdata": torch.uint8, "retdata_len": torch.int32,
                 "storage_keys": torch.int32, "storage_vals": torch.int32,
                 "storage_used": torch.bool, "tstore_keys": torch.int32,
                 "tstore_vals": torch.int32, "tstore_used": torch.bool}

_PLANE_DTYPES = {"stack_sym": torch.int32, "mem_sym": torch.int32,
                 "storage_sym": torch.int32, "storage_dirty": torch.bool,
                 "storage_base_sym": torch.bool, "conds": torch.int32,
                 "cond_count": torch.int32, "fork_cond": torch.int32,
                 "symbolic_env": torch.bool, "ctx_id": torch.int32,
                 "branches": torch.int32, "last_jump": torch.int32}


def _leaf_ptrs(tree, dtypes, batch, what) -> list:
    ptrs = []
    for name, leaf in zip(type(tree)._fields, tree):
        if leaf.shape[0] != batch:
            raise ValueError(f"{what}.{name}: {leaf.shape[0]} rows, expected {batch}")
        ptrs.append(_check(leaf, f"{what}.{name}", dtypes.get(name, torch.int32)))
    return ptrs


def _k2_blocks(state, force_escape, force_fork):
    """The parameter block of K2 and of K1's step form for `state` (and the
    forced-lane masks, or none), with the digests it owns."""
    dims = _state_dims(state)
    batch = dims["B"]
    values = [0] * Lay.K2_NARGS
    values[:Lay.N_STATE_LEAVES] = _leaf_ptrs(state, _STATE_DTYPES, batch, "state")
    for key, slot in (("B", Lay.K2_B), ("S", Lay.K2_S), ("M", Lay.K2_M),
                      ("C", Lay.K2_C), ("D", Lay.K2_D), ("R", Lay.K2_R),
                      ("K", Lay.K2_K), ("T", Lay.K2_T)):
        values[slot] = dims[key]
    if (force_escape is None) != (force_fork is None):
        raise ValueError("force_escape and force_fork go together")
    if force_escape is not None:
        values[Lay.K2_FORCE_ESCAPE] = _check(force_escape, "force_escape",
                                             torch.bool, (batch,))
        values[Lay.K2_FORCE_FORK] = _check(force_fork, "force_fork",
                                           torch.bool, (batch,))
    dev = state.stack.device
    values[Lay.K2_OPTAB] = optab(dev).data_ptr()
    digest = torch.zeros((batch, 32), dtype=torch.uint8, device=dev)
    values[Lay.K2_DIGEST] = digest.data_ptr()
    return _block("mtpu_evm_step", values), digest


def _k2_launch(k2) -> None:
    """K1's step form (it hashes the SHA3 lanes it finds), then K2."""
    _call("mtpu_keccak_step", k2)
    LAUNCHES["keccak"] += 1
    _call("mtpu_evm_step", k2)
    LAUNCHES["evm_step"] += 1


_K2_PLANS = _Plans(limit=8)


def evm_step(state, force_escape: Optional[torch.Tensor] = None,
             force_fork: Optional[torch.Tensor] = None):
    """K2 (after K1's step form, which hashes the SHA3 lanes): one
    instruction for every lane, in place. Their parameter block and digests
    are built once for a set of tensors (keyed on their data pointers,
    shapes and dtypes) and reused while the key holds. Returns the same
    StateBatch."""
    _check(state.stack, "state.stack", torch.int32)
    masks = (force_escape, force_fork)
    k2, _ = _K2_PLANS.get(
        list(state) + [m for m in masks if m is not None],
        tuple(m is None for m in masks),
        lambda: _k2_blocks(state, force_escape, force_fork))
    _k2_launch(k2)
    return state


def _grid(entry: str, n: int = 2) -> tuple:
    """The grid and block sizes a source's last launches recorded."""
    out = (ctypes.c_longlong * n)()
    _call(entry, out)
    return tuple(int(v) for v in out)


def evm_step_grid() -> tuple:
    """(blocks, threads) of the last `evm_step_kernel` launch, as that
    launch recorded them."""
    return _grid("mtpu_evm_step_grid")


def keccak_step_grid() -> tuple:
    """(blocks, threads) of the last launch of K1's step form
    (`keccak_step_kernel`), as that launch recorded them."""
    return _grid("mtpu_keccak_step_grid")


# ---- K3 -----------------------------------------------------------------------------

def _as_lane_int(value, batch, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        value = value.to(device=device, dtype=torch.int32).expand(batch)
        return value.contiguous()
    return torch.full((batch,), int(value), dtype=torch.int32, device=device)


def arena_alloc(arena, want: torch.Tensor, values: Optional[torch.Tensor] = None,
                op=0, a=0, b=0, c=0, imm=0, imm2=0,
                out_ids: Optional[torch.Tensor] = None,
                out_ovf: Optional[torch.Tensor] = None):
    """K3: node allocation (`values` None) or const allocation (`values`
    int32[B, 16]) for the entries of `want`, in place (any number of
    entries; `out_ids` must not alias an input). Returns (arena, ids,
    overflow)."""
    batch = want.shape[0]
    dev = arena.op.device
    slots = [0] * Lay.K3_NARGS
    slots[Lay.K3_WANT] = _check(want, "want", torch.bool, (batch,))
    keep = []
    if values is not None:
        slots[Lay.K3_VALUES] = _check(values, "values", torch.int32, (batch, 16))
    else:
        for slot, value, what in ((Lay.K3_OP, op, "op"), (Lay.K3_A, a, "a"),
                                  (Lay.K3_B, b, "b"), (Lay.K3_C, c, "c"),
                                  (Lay.K3_IMM, imm, "imm"),
                                  (Lay.K3_IMM2, imm2, "imm2")):
            tensor = _as_lane_int(value, batch, dev)
            keep.append(tensor)
            slots[slot] = _check(tensor, what, torch.int32, (batch,))
    for slot, col in ((Lay.K3_COL_OP, arena.op), (Lay.K3_COL_A, arena.a),
                      (Lay.K3_COL_B, arena.b), (Lay.K3_COL_C, arena.c),
                      (Lay.K3_COL_IMM, arena.imm), (Lay.K3_COL_IMM2, arena.imm2),
                      (Lay.K3_COL_CLS, arena.cls)):
        slots[slot] = _check(col, "arena column", torch.int32)
    slots[Lay.K3_N] = _check(arena.n, "arena.n", torch.int32, ())
    slots[Lay.K3_CAP] = arena.op.shape[0]
    slots[Lay.K3_CONST_VALS] = _check(arena.const_vals, "arena.const_vals",
                                      torch.int32)
    slots[Lay.K3_N_CONST] = _check(arena.n_const, "arena.n_const",
                                   torch.int32, ())
    slots[Lay.K3_CCAP] = arena.const_vals.shape[0]
    if out_ids is None:
        out_ids = torch.empty(batch, dtype=torch.int32, device=dev)
    if out_ovf is None:
        out_ovf = torch.empty(batch, dtype=torch.bool, device=dev)
    slots[Lay.K3_OUT_IDS] = _check(out_ids, "out_ids", torch.int32, (batch,))
    slots[Lay.K3_OUT_OVF] = _check(out_ovf, "out_ovf", torch.bool, (batch,))
    slots[Lay.K3_BATCH] = batch
    _launch("mtpu_arena_alloc", slots)
    LAUNCHES["arena_alloc"] += 1
    return arena, out_ids, out_ovf


# ---- K4 -----------------------------------------------------------------------------

#: K4's launch geometry on the card: lanes per block (the scan tile) and
#: threads per lane of its wide launches (a warp)
LANES_PER_BLOCK = 4
LANE_GROUP = 32
#: bytes of a row slice one block of the move launch copies
_MOVE_SLICE = 4096


def _copy_plan(row_bytes, device):
    """A row's copy plan: (leaf, byte offset, bytes) entries of at most one
    slice, grouped in order into items of at most one slice each."""
    entries = []
    for position, nbytes in enumerate(row_bytes):
        for off in range(0, nbytes, _MOVE_SLICE):
            entries.append((position, off, min(_MOVE_SLICE, nbytes - off)))
    items, size = [0], 0
    for index, (_, _, nbytes) in enumerate(entries):
        if size and size + nbytes > _MOVE_SLICE:
            items.append(index)
            size = 0
        size += nbytes
    items.append(len(entries))
    return (torch.tensor(entries, dtype=torch.int32, device=device).reshape(-1, 3),
            torch.tensor(items, dtype=torch.int32, device=device))


class _StepPlan:
    """One symbolic step's parameter blocks (K4, K2, K1) and scratch for
    one set of tensors and launch geometry."""

    def __init__(self, state, planes, arena, sched, lanes_per_block, group):
        dims = _state_dims(state)
        batch = dims["B"]
        dev = state.stack.device
        if not 1 <= lanes_per_block <= 64 or group < 1 \
                or lanes_per_block * group > 1024:
            raise ValueError(f"sym_step: {lanes_per_block} lanes of {group} "
                             "threads a block")
        lane_ptrs = (_leaf_ptrs(state, _STATE_DTYPES, batch, "state")
                     + _leaf_ptrs(planes, _PLANE_DTYPES, batch, "planes"))
        pool_rows = sched.stack_state.stack.shape[0]
        esc_rows = sched.esc_state.stack.shape[0]
        pool_ptrs = (_leaf_ptrs(sched.stack_state, _STATE_DTYPES, pool_rows, "pool")
                     + _leaf_ptrs(sched.stack_planes, _PLANE_DTYPES, pool_rows,
                                  "pool"))
        esc_ptrs = (_leaf_ptrs(sched.esc_state, _STATE_DTYPES, esc_rows, "esc")
                    + _leaf_ptrs(sched.esc_planes, _PLANE_DTYPES, esc_rows, "esc"))
        n_seg = n_segments(sched)
        if batch % n_seg or pool_rows % n_seg or esc_rows % n_seg:
            raise ValueError(f"{n_seg} shards do not divide {batch} lanes, "
                             f"{pool_rows} stack or {esc_rows} escape rows")
        row_bytes = []
        for lane_leaf, pool_leaf, esc_leaf in zip(
                list(state) + list(planes),
                list(sched.stack_state) + list(sched.stack_planes),
                list(sched.esc_state) + list(sched.esc_planes)):
            if lane_leaf.shape[1:] != pool_leaf.shape[1:] \
                    or lane_leaf.shape[1:] != esc_leaf.shape[1:]:
                raise ValueError("scheduler rows do not match the lane rows")
            row_bytes.append(lane_leaf[0].numel() * lane_leaf.element_size())
        n_tiles = -(-batch // lanes_per_block)

        def scratch(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.iscr = scratch(Lay.N_ISCR, batch)
        self.fscr = scratch(Lay.N_FSCR, batch, dtype=torch.bool)
        self.wscr = scratch(Lay.N_WSCR, batch, 16)
        self.entries, self.items = _copy_plan(row_bytes, dev)
        work = {Lay.K4_SCAN: scratch(Lay.N_SC, batch),
                Lay.K4_BTOT: scratch(Lay.N_SC, n_tiles),
                Lay.K4_BPRE: scratch(Lay.N_SC, n_tiles + 1),
                Lay.K4_SEG: scratch(Lay.N_SEGF, n_seg),
                Lay.K4_MOVES: scratch(Lay.N_MVF, batch),
                Lay.K4_NMOVES: scratch(Lay.N_PHASES),
                Lay.K4_ALLOC: scratch(Lay.N_ALLOC),
                Lay.K4_DEAD_MAP: scratch(batch)}
        self.work = list(work.values())

        from ..parallel.arena import PREDICTABLE_MASK

        values = [0] * Lay.K4_NARGS
        values[Lay.K4_LANE:Lay.K4_LANE + Lay.N_ROW_LEAVES] = lane_ptrs
        values[Lay.K4_POOL:Lay.K4_POOL + Lay.N_ROW_LEAVES] = pool_ptrs
        values[Lay.K4_ESC:Lay.K4_ESC + Lay.N_ROW_LEAVES] = esc_ptrs
        values[Lay.K4_ROW_BYTES:Lay.K4_ROW_BYTES + Lay.N_ROW_LEAVES] = row_bytes
        for slot, value in ((Lay.K4_B, batch), (Lay.K4_S, dims["S"]),
                            (Lay.K4_M, dims["M"]), (Lay.K4_C, dims["C"]),
                            (Lay.K4_K, dims["K"]),
                            (Lay.K4_KC, planes.conds.shape[1]),
                            (Lay.K4_P, pool_rows), (Lay.K4_E, esc_rows),
                            (Lay.K4_CAP, arena.op.shape[0]),
                            (Lay.K4_PRED_MASK, PREDICTABLE_MASK),
                            (Lay.K4_D, n_seg),
                            (Lay.K4_LPB, lanes_per_block),
                            (Lay.K4_GROUP, group), (Lay.K4_NB, n_tiles),
                            (Lay.K4_N_ITEMS, self.items.shape[0] - 1),
                            (Lay.K4_AR_CCAP, arena.const_vals.shape[0])):
            values[slot] = value
        for slot, col, what in ((Lay.K4_CLS, arena.cls, "arena.cls"),
                                (Lay.K4_AR_OP, arena.op, "arena.op"),
                                (Lay.K4_AR_A, arena.a, "arena.a"),
                                (Lay.K4_AR_B, arena.b, "arena.b"),
                                (Lay.K4_AR_C, arena.c, "arena.c"),
                                (Lay.K4_AR_IMM, arena.imm, "arena.imm"),
                                (Lay.K4_AR_IMM2, arena.imm2, "arena.imm2")):
            values[slot] = _check(col, what, torch.int32, (arena.op.shape[0],))
        values[Lay.K4_AR_CONST] = _check(arena.const_vals, "arena.const_vals",
                                         torch.int32)
        values[Lay.K4_AR_N] = _check(arena.n, "arena.n", torch.int32, ())
        values[Lay.K4_AR_N_CONST] = _check(arena.n_const, "arena.n_const",
                                           torch.int32, ())
        for slot, tensor, what in ((Lay.K4_STACK_TOP, sched.stack_top, "stack_top"),
                                   (Lay.K4_ESC_COUNT, sched.esc_count, "esc_count")):
            values[slot] = _check(tensor, what, torch.int32,
                                  tuple(sched.stack_top.shape))
        for slot, tensor, dtype in (
                (Lay.K4_EXECUTED, sched.executed, torch.int64),
                (Lay.K4_FORKS, sched.forks, torch.int64),
                (Lay.K4_PUSHES, sched.pushes, torch.int64),
                (Lay.K4_POPS, sched.pops, torch.int64),
                (Lay.K4_ENABLED, sched.enabled, torch.bool)):
            values[slot] = _check(tensor, "scheduler scalar", dtype, ())
        values[Lay.K4_OPTAB] = optab(dev).data_ptr()
        values[Lay.K4_ISCR] = self.iscr.data_ptr()
        values[Lay.K4_FSCR] = self.fscr.data_ptr()
        values[Lay.K4_WSCR] = self.wscr.data_ptr()
        values[Lay.K4_ENTRIES] = self.entries.data_ptr()
        values[Lay.K4_ITEMS] = self.items.data_ptr()
        for slot, tensor in work.items():
            values[slot] = tensor.data_ptr()
        tel = sched.telemetry
        self.telemetry = tel is not None
        if tel is not None:
            for slot, tensor, n in _tel_parts(tel, Lay.K4_TEL_OP_HIST,
                                              Lay.K4_TEL_LIFECYCLE,
                                              Lay.K4_TEL_ESC_CAUSE,
                                              Lay.K4_TEL_OCCUPANCY, Lay.K4_TEL_HWM,
                                              Lay.K4_TEL_TAG_OCC,
                                              Lay.K4_TEL_FLEET_OCC):
                values[slot] = _check(tensor, "telemetry", torch.int64, (n,))
            n_tags, n_fleet = tel.tag_occ.shape[0], tel.fleet_occ.shape[0]
            n_ctx = tel.fleet_slots.shape[0]
            if max(n_tags, n_fleet) > MAX_TEL_SLOTS or (n_fleet and not n_ctx):
                raise ValueError("telemetry: tag or fleet table out of range")
            values[Lay.K4_TEL_TAG_PCS] = _check(tel.tag_pcs, "tag_pcs",
                                                torch.int32, (n_tags,))
            values[Lay.K4_TEL_FLEET_SLOTS] = _check(tel.fleet_slots,
                                                    "fleet_slots", torch.int32,
                                                    (n_ctx,))
            values[Lay.K4_TEL_N_TAGS] = n_tags
            values[Lay.K4_TEL_N_CTX] = n_ctx
            values[Lay.K4_TEL_N_FLEET] = n_fleet
            # K9's per-step count table: a byte a block of each column,
            # the blocks padded to 16-byte words
            self.tel_rows = scratch(Lay.N_TC, -(-n_tiles // 16) * 16,
                                    dtype=torch.uint8)
            values[Lay.K4_TEL_ROWS] = self.tel_rows.data_ptr()
        suffix = "_tel" if self.telemetry else ""
        self.pre, self.post = "mtpu_sym_pre" + suffix, "mtpu_sym_post" + suffix
        self.k4 = _block(self.pre, values)
        self.k2, self.digest = _k2_blocks(
            state, self.fscr[Lay.F_FORCE_ESCAPE], self.fscr[Lay.F_FORCE_FORK])

    def launch(self) -> None:
        """One step: K4's pre launches, K1's step form, K2, K4's post
        launches."""
        _call(self.pre, self.k4)
        _k2_launch(self.k2)
        _call(self.post, self.k4)
        LAUNCHES["sym_step"] += 1
        LAUNCHES["arena_alloc_step"] += 1
        if self.telemetry:
            LAUNCHES["telemetry"] += 1


def _step_parts(state, planes, arena, sched, lanes_per_block: int,
                group: int) -> tuple:
    """What K4's cached parameter block depends on: every tensor, then the
    telemetry plane and the launch geometry."""
    tensors = (list(state) + list(planes) + list(arena)
               + list(sched.stack_state) + list(sched.stack_planes)
               + list(sched.esc_state) + list(sched.esc_planes)
               + [sched.stack_top, sched.esc_count, sched.executed,
                  sched.forks, sched.pushes, sched.pops, sched.enabled])
    if sched.telemetry is not None:
        tensors += list(sched.telemetry)
    return tensors, (sched.telemetry is not None, lanes_per_block, group)


def step_key(state, planes, arena, sched, lanes_per_block: int = LANES_PER_BLOCK,
             group: int = LANE_GROUP) -> tuple:
    """K4's plan key: every tensor's data pointer, shape and dtype, the
    telemetry plane and the launch geometry."""
    return _key(*_step_parts(state, planes, arena, sched, lanes_per_block, group))


_PLANS = _Plans(limit=8)


def step_plan(state, planes, arena, sched, lanes_per_block: int = LANES_PER_BLOCK,
              group: int = LANE_GROUP) -> _StepPlan:
    """The cached step plan of these tensors (built on a miss)."""
    return _PLANS.get(*_step_parts(state, planes, arena, sched, lanes_per_block,
                                   group),
                      lambda: _StepPlan(state, planes, arena, sched,
                                        lanes_per_block, group))


def sym_step(state, planes, arena, sched, lanes_per_block: int = LANES_PER_BLOCK,
             group: int = LANE_GROUP):
    """K4 around K2 (and K1), K3's four allocations folded in: one symbolic
    step for every lane, every tensor updated in place, any lane count. With
    the telemetry plane armed, the counting launches are their TEL
    instantiations (K9). `lanes_per_block` lanes share a block (the scan
    tile); the wide launches run `group` threads a lane."""
    step_plan(state, planes, arena, sched, lanes_per_block, group).launch()
    return state, planes, arena, sched


_GRAPHS = _Plans(limit=4)

#: the REPLAYS entry counting each kind's captures
_CAPTURES = {"run_chunk": "captures", "sat_chunk": "sat_captures",
             "sat_shard_chunk": "sat_shard_captures"}


@functools.cache
def _preload(entries: tuple) -> None:
    """Load a graph's kernels before its first capture (the runtime would
    load each at its first launch)."""
    for name in entries:
        rc = _entry(name)(None, 0, None)
        if rc != 0:
            raise RuntimeError(f"{name}: failed (cudaError {rc})")


def _replay(cache: _Plans, tensors: list, static: tuple, prepare,
            entries: tuple, kind: str) -> None:
    """Replay the CUDA graph cached for `tensors` and `static`, capturing it
    on a miss:
    `prepare()` builds what the launches need (outside the capture) and
    returns the function that launches them, which the graph keeps, and with
    it the scratch the captured kernels point at. A replay adds the
    captured launches to `LAUNCHES` and counts in `REPLAYS[kind]`; a
    capture launches nothing. A failed capture or replay raises."""
    def capture():
        launch = prepare()
        _preload(entries)
        before = dict(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                launch()
            counts = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
        finally:
            LAUNCHES.update(before)
        REPLAYS[_CAPTURES[kind]] += 1
        return graph, launch, counts

    graph, _, counts = cache.get(tensors, static, capture)
    graph.replay()
    for name, count in counts.items():
        LAUNCHES[name] += count
    REPLAYS[kind] += 1


def run_chunk_graph(state, planes, arena, sched, n_steps: int):
    """`n_steps` symbolic steps as one CUDA graph: captured once for a key
    (`step_key` and the step count; tensors rebound to new storage make a
    new key and a new capture) and replayed on the current stream. A
    failed capture or replay raises."""
    if n_steps < 1:
        raise ValueError(f"run_chunk_graph: {n_steps} steps")

    def prepare():
        plan = step_plan(state, planes, arena, sched)

        def launch():
            for _ in range(n_steps):
                plan.launch()
        return launch

    tensors, static = _step_parts(state, planes, arena, sched, LANES_PER_BLOCK,
                                  LANE_GROUP)
    _replay(_GRAPHS, tensors, static + (n_steps,), prepare, ("mtpu_sym_preload", "mtpu_evm_preload",
                      "mtpu_keccak_preload"), "run_chunk")
    return state, planes, arena, sched


# ---- K5 -----------------------------------------------------------------------------

def _tel_parts(tel, *slots):
    """(slot, counter tensor, length) of the plane's int64 counters, in
    `telemetry_words` order, for the given parameter slots."""
    counters = (tel.op_hist, tel.lifecycle, tel.esc_cause, tel.occupancy,
                tel.hwm, tel.tag_occ, tel.fleet_occ)
    return [(slot, tensor, tensor.shape[0])
            for slot, tensor in zip(slots, counters)]


def _summary_tensors(state, planes, arena, sched) -> list:
    """Every tensor K5's cached plan reads."""
    tensors = [state.status, planes.fork_cond, planes.ctx_id, sched.stack_top,
               sched.esc_count, sched.executed, sched.forks, sched.pushes,
               sched.pops, arena.n, arena.n_const, sched.esc_state.msize,
               sched.esc_state.sp, sched.esc_state.storage_used,
               sched.esc_planes.cond_count]
    if sched.telemetry is not None:
        tensors += list(sched.telemetry)
    if sched.stack_top.dim():
        tensors += [sched.steals_sent, sched.steals_received, sched.steal_rows]
    return tensors


class _SummaryPlan:
    """K5's parameter block for one set of tensors, with the persistent
    device output (int64[13 + 3B], then the telemetry words when the plane
    is armed, then a sharded scheduler's shard block of 4D + 1 words) and
    the blocks' maxima (int64[4 x escape rows]: a block takes one row at
    least)."""

    def __init__(self, state, planes, arena, sched):
        batch = state.status.shape[0]
        esc_rows, slots = sched.esc_state.storage_used.shape
        values = [0] * Lay.K5_NARGS
        for slot, tensor, what in ((Lay.K5_STATUS, state.status, "status"),
                                   (Lay.K5_FORK_COND, planes.fork_cond, "fork_cond"),
                                   (Lay.K5_CTX_ID, planes.ctx_id, "ctx_id")):
            values[slot] = _check(tensor, what, torch.int32, (batch,))
        n_seg = n_segments(sched)
        if esc_rows % n_seg:
            raise ValueError(f"{n_seg} shards do not divide {esc_rows} escape rows")
        for slot, tensor, what in ((Lay.K5_STACK_TOP, sched.stack_top, "stack_top"),
                                   (Lay.K5_ESC_COUNT, sched.esc_count, "esc_count")):
            values[slot] = _check(tensor, what, torch.int32,
                                  tuple(sched.stack_top.shape))
        for slot, tensor, dtype in (
                (Lay.K5_EXECUTED, sched.executed, torch.int64),
                (Lay.K5_FORKS, sched.forks, torch.int64),
                (Lay.K5_PUSHES, sched.pushes, torch.int64),
                (Lay.K5_POPS, sched.pops, torch.int64),
                (Lay.K5_ARENA_N, arena.n, torch.int32),
                (Lay.K5_ARENA_N_CONST, arena.n_const, torch.int32)):
            values[slot] = _check(tensor, "summary scalar", dtype, ())
        for slot, tensor, what, dtype, shape in (
                (Lay.K5_ESC_MSIZE, sched.esc_state.msize, "esc.msize",
                 torch.int32, (esc_rows,)),
                (Lay.K5_ESC_SP, sched.esc_state.sp, "esc.sp", torch.int32,
                 (esc_rows,)),
                (Lay.K5_ESC_STORAGE_USED, sched.esc_state.storage_used,
                 "esc.storage_used", torch.bool, (esc_rows, slots)),
                (Lay.K5_ESC_COND_COUNT, sched.esc_planes.cond_count,
                 "esc.cond_count", torch.int32, (esc_rows,))):
            values[slot] = _check(tensor, what, dtype, shape)
        values[Lay.K5_B] = batch
        values[Lay.K5_E] = esc_rows
        values[Lay.K5_K] = slots
        n_words = 13 + 3 * batch
        tel = sched.telemetry
        if tel is not None:
            for slot, tensor, n in _tel_parts(tel, Lay.K5_TEL_OP_HIST,
                                              Lay.K5_TEL_LIFECYCLE,
                                              Lay.K5_TEL_ESC_CAUSE,
                                              Lay.K5_TEL_OCCUPANCY, Lay.K5_TEL_HWM,
                                              Lay.K5_TEL_TAG_OCC,
                                              Lay.K5_TEL_FLEET_OCC):
                values[slot] = _check(tensor, "telemetry", torch.int64, (n,))
                n_words += n
            values[Lay.K5_TEL_N_TAGS] = tel.tag_occ.shape[0]
            values[Lay.K5_TEL_N_FLEET] = tel.fleet_occ.shape[0]
        values[Lay.K5_D] = n_seg
        if n_seg > 1:
            for slot, tensor, shape in (
                    (Lay.K5_STEALS_SENT, sched.steals_sent, (n_seg,)),
                    (Lay.K5_STEALS_RECEIVED, sched.steals_received, (n_seg,)),
                    (Lay.K5_STEAL_ROWS, sched.steal_rows, ())):
                values[slot] = _check(tensor, "steal counter", torch.int64, shape)
            n_words += 4 * n_seg + 1
        dev = state.status.device
        self.out = torch.empty(n_words, dtype=torch.int64, device=dev)
        self.partial = torch.empty(4 * esc_rows, dtype=torch.int64, device=dev)
        values[Lay.K5_OUT] = self.out.data_ptr()
        values[Lay.K5_PARTIAL] = self.partial.data_ptr()
        self.block = _block("mtpu_frontier_summary", values)

    def launch(self) -> torch.Tensor:
        """One summary into the plan's output, which the next launch of
        this plan overwrites."""
        _call("mtpu_frontier_summary", self.block)
        LAUNCHES["frontier_summary"] += 1
        return self.out


_SUMMARY_PLANS = _Plans(limit=8)


def summary_plan(state, planes, arena, sched) -> _SummaryPlan:
    """K5's plan for these tensors, built on a miss."""
    return _SUMMARY_PLANS.get(_summary_tensors(state, planes, arena, sched), (),
                              lambda: _SummaryPlan(state, planes, arena, sched))


def frontier_summary(state, planes, arena, sched) -> torch.Tensor:
    """K5: the chunk summary, int64[13 + 3B], then the telemetry words when
    the plane is armed, then a sharded scheduler's shard block (4D + 1
    words): a grid over the escape rows, then one block that combines the
    blocks' maxima. Returns the plan's device output: the next summary of
    the same tensors overwrites it."""
    _check(state.status, "status", torch.int32)
    return summary_plan(state, planes, arena, sched).launch()


def frontier_summary_grid() -> tuple:
    """(blocks, threads) of the last `frontier_summary_kernel` launch, as
    that launch recorded them."""
    return _grid("mtpu_frontier_summary_grid")


# ---- K6 -----------------------------------------------------------------------------

class _RowSourcePlan:
    """K6's parameter block for one source tree (the escape pool's rows, or
    the lanes'): the checked leaves and the row sizes, and `row_maxima`'s
    scratch of four words a block (a block takes one row at least), grown
    to the longest index yet. A call fills the index, its length, the
    widths and the outputs."""

    def __init__(self, state_like, planes_like):
        self.rows = state_like.status.shape[0]
        values = [0] * Lay.K6_NARGS
        values[Lay.K6_LEAF:Lay.K6_LEAF + Lay.N_ROW_LEAVES] = (
            _leaf_ptrs(state_like, _STATE_DTYPES, self.rows, "rows")
            + _leaf_ptrs(planes_like, _PLANE_DTYPES, self.rows, "rows"))
        values[Lay.K6_ROWS] = self.rows
        values[Lay.K6_S] = state_like.stack.shape[1]
        values[Lay.K6_M] = state_like.memory.shape[1]
        values[Lay.K6_K] = state_like.storage_keys.shape[1]
        values[Lay.K6_KC] = planes_like.conds.shape[1]
        self.block = _block("mtpu_pack_rows", values)
        self.device = state_like.status.device
        self.partial = None

    def select(self, index: torch.Tensor) -> int:
        """Point the block at `index`; returns its length."""
        n = index.shape[0]
        if n == 0:
            raise ValueError("index: no rows selected")
        self.block[Lay.K6_INDEX] = _check(index, "index", torch.int32, (n,))
        self.block[Lay.K6_N] = n
        return n


_ROW_PLANS = _Plans(limit=8)


def row_plan(state_like, planes_like) -> _RowSourcePlan:
    """K6's cached plan for these source rows (built on a miss)."""
    return _ROW_PLANS.get(list(state_like) + list(planes_like), (),
                          lambda: _RowSourcePlan(state_like, planes_like))


def row_maxima(state_like, planes_like, index: torch.Tensor) -> torch.Tensor:
    """K6 `row_maxima`: int64[4] maxima of msize, sp, used storage slots
    and cond_count over the rows of `index`: a grid over the rows, then
    one block that combines the blocks' maxima."""
    plan = row_plan(state_like, planes_like)
    n = plan.select(index)
    if plan.partial is None or plan.partial.shape[0] < 4 * n:
        plan.partial = torch.empty(4 * n, dtype=torch.int64, device=plan.device)
        plan.block[Lay.K6_PARTIAL] = plan.partial.data_ptr()
    out = torch.empty(4, dtype=torch.int64, device=plan.device)
    plan.block[Lay.K6_OUT_MAXIMA] = out.data_ptr()
    _call("mtpu_row_maxima", plan.block)
    LAUNCHES["pack_rows"] += 1
    return out


def pack_rows(state_like, planes_like, index: torch.Tensor, mem_b: int,
              sp_b: int, st_b: int, conds_w: int):
    """K6 `pack_rows`: the rows of `index` packed into (int32, uint8, int64)
    flat blocks at the widths given."""
    plan = row_plan(state_like, planes_like)
    block = plan.block
    for name, width, cap in (("mem_b", mem_b, block[Lay.K6_M]),
                             ("sp_b", sp_b, block[Lay.K6_S]),
                             ("st_b", st_b, block[Lay.K6_K]),
                             ("conds_w", conds_w, block[Lay.K6_KC])):
        if not 0 <= width <= cap:
            raise ValueError(f"{name} = {width} outside [0, {cap}]")
    n = plan.select(index)
    i32 = torch.empty(n * (8 + 16 * sp_b + 32 * st_b + sp_b + mem_b + st_b
                           + conds_w), dtype=torch.int32, device=plan.device)
    u8 = torch.empty(n * (mem_b + 2 * st_b), dtype=torch.uint8, device=plan.device)
    gas = torch.empty(n, dtype=torch.int64, device=plan.device)
    for slot, value in ((Lay.K6_MEM_B, mem_b), (Lay.K6_SP_B, sp_b),
                        (Lay.K6_ST_B, st_b), (Lay.K6_CONDS_W, conds_w),
                        (Lay.K6_OUT_I32, i32.data_ptr()),
                        (Lay.K6_OUT_U8, u8.data_ptr()),
                        (Lay.K6_OUT_GAS, gas.data_ptr())):
        block[slot] = value
    _call("mtpu_pack_rows", block)
    LAUNCHES["pack_rows"] += 1
    return i32, u8, gas


_RESET_PLANS = _Plans(limit=8)


def reset_esc(sched):
    """K6 `reset_esc`: the scheduler's escape count (every segment's) to 0,
    in place, from a block cached for its escape-count tensor."""
    def build():
        values = [0] * Lay.K6_NARGS
        values[Lay.K6_ESC_COUNT] = _check(sched.esc_count, "esc_count",
                                          torch.int32,
                                          tuple(sched.esc_count.shape))
        values[Lay.K6_ESC_SEGMENTS] = sched.esc_count.numel()
        return _block("mtpu_reset_esc", values)

    _call("mtpu_reset_esc", _RESET_PLANS.get([sched.esc_count], (), build))
    LAUNCHES["pack_rows"] += 1
    return sched


def pack_rows_grid() -> dict:
    """{entry: (blocks, threads)} of the last launch of each K6 entry, as
    the launches recorded them (`row_maxima`'s grid; its combining launch
    is one block of 128)."""
    grid = _grid("mtpu_pack_rows_grid", 6)
    return {"row_maxima": grid[0:2], "pack_rows": grid[2:4],
            "reset_esc": grid[4:6]}


# ---- K7 -----------------------------------------------------------------------------

class _RowsPlan:
    """K7's parameter blocks for one set of lane rows and a gather or
    scatter of `n` rows: the checked lane leaves, the flat block's layout
    (`batch.row_layout`), the row copy plan and its grid."""

    def __init__(self, state, planes, n: int):
        rows = state.status.shape[0]
        leaves = list(state) + list(planes)
        values = [0] * Lay.K7_NARGS
        values[Lay.K7_LANE:Lay.K7_LANE + Lay.N_ROW_LEAVES] = (
            _leaf_ptrs(state, _STATE_DTYPES, rows, "rows")
            + _leaf_ptrs(planes, _PLANE_DTYPES, rows, "rows"))
        row_bytes = [math.prod(leaf.shape[1:]) * leaf.element_size()
                     for leaf in leaves]
        self.slabs, self.total = row_layout(leaves, n)
        values[Lay.K7_SLAB:Lay.K7_SLAB + Lay.N_ROW_LEAVES] = [
            offset * leaf.element_size()
            for (_, _, _, offset), leaf in zip(self.slabs, leaves)]
        values[Lay.K7_ROW_BYTES:Lay.K7_ROW_BYTES + Lay.N_ROW_LEAVES] = row_bytes
        dev = state.status.device
        self.entries, self.items = _copy_plan(row_bytes, dev)
        n_items = self.items.shape[0] - 1
        for slot, value in ((Lay.K7_N, n), (Lay.K7_ROWS, rows),
                            (Lay.K7_ENTRIES, self.entries.data_ptr()),
                            (Lay.K7_ITEMS, self.items.data_ptr()),
                            (Lay.K7_N_ITEMS, n_items)):
            values[slot] = value
        self.n_state = len(state)
        #: (dtype, shape, device) a scatter's source leaves must have
        self.row_sig = [(dtype, shape, dev) for dtype, shape, _, _ in self.slabs]
        self.blocks = n * n_items
        self.gather = _block("mtpu_gather_rows", values)
        self.scatter = _block("mtpu_scatter_rows", values)
        self.device = dev


_ROWS_PLANS = _Plans(limit=8)


def rows_plan(state, planes, index: torch.Tensor) -> _RowsPlan:
    """K7's cached plan for these lane rows and `index` (built on a miss)."""
    n = index.shape[0]
    if n == 0:
        raise ValueError("index: no rows selected")
    _check(index, "index", torch.int32, (n,))
    return _ROWS_PLANS.get(list(state) + list(planes), (n,),
                           lambda: _RowsPlan(state, planes, n))


def gather_rows_flat(state, planes, index: torch.Tensor):
    """K7 gather into one new flat uint8 buffer: the rows of `index` of
    every leaf, leaf-major as `batch.row_layout` lays them out (an
    out-of-range index clamps). Returns (buffer, plan); `plan.slabs` gives
    the leaf views (`batch.row_views`)."""
    plan = rows_plan(state, planes, index)
    flat = torch.empty(plan.total, dtype=torch.uint8, device=plan.device)
    plan.gather[Lay.K7_INDEX] = index.data_ptr()
    plan.gather[Lay.K7_BASE] = flat.data_ptr()
    _call("mtpu_gather_rows", plan.gather)
    LAUNCHES["gather_rows"] += 1
    return flat, plan


def gather_rows(state, planes, index: torch.Tensor):
    """K7 gather: the rows of `index` of every leaf, as new (StateBatch,
    SymPlanes) whose leaves are contiguous views of one flat buffer."""
    flat, plan = gather_rows_flat(state, planes, index)
    views = row_views(flat, plan.slabs)
    return (type(state)(*views[:plan.n_state]),
            type(planes)(*views[plan.n_state:]))


def scatter_rows(state, planes, index: torch.Tensor, rows_state, rows_planes):
    """K7 scatter: row i of (rows_state, rows_planes) to lane index[i] of
    every leaf, in place; indices outside [0, lanes) are dropped. The rows
    may be any contiguous tensors of the lanes' row shapes and dtypes (a
    gather's views, or separate leaves)."""
    plan = rows_plan(state, planes, index)
    leaves = list(rows_state) + list(rows_planes)
    if [(leaf.dtype, tuple(leaf.shape), leaf.device) for leaf in leaves] \
            != plan.row_sig or not all(leaf.is_contiguous() for leaf in leaves):
        raise ValueError("scatter_rows: the rows do not match the lane rows")
    plan.scatter[Lay.K7_INDEX] = index.data_ptr()
    plan.scatter[Lay.K7_SLAB:Lay.K7_SLAB + Lay.N_ROW_LEAVES] = [
        leaf.data_ptr() for leaf in leaves]
    _call("mtpu_scatter_rows", plan.scatter)
    LAUNCHES["gather_rows"] += 1
    return state, planes


# ---- K8 -----------------------------------------------------------------------------

def _pinned_int32(n: int) -> torch.Tensor:
    """n int32 words of pinned host memory (K8's staging)."""
    return torch.empty(n, dtype=torch.int32, pin_memory=True)


def _mapped_address(host: torch.Tensor) -> int:
    """The device address of pinned host memory, as the CUDA runtime gives
    it (cudaHostGetDevicePointer in arena_delta.cu)."""
    values = (ctypes.c_longlong * 2)(host.data_ptr(), 0)
    rc = _entry("mtpu_arena_delta_map")(ctypes.cast(values, ctypes.c_void_p),
                                        2, None)
    if rc != 0:
        raise RuntimeError(f"mtpu_arena_delta_map: cudaError {rc}")
    return values[1]


def _launch_after_current(name: str, block, device, event):
    """Launch `name` on the device's copy stream once the work queued on the
    current stream is done, and record `event` (a new one when None) on
    the copy stream after it; returns the event."""
    from .. import device as _device

    side = _device.copy_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    _call(name, block, side.cuda_stream)
    if event is None:
        event = torch.cuda.Event()
    event.record(side)
    return event


class _DeltaPlan:
    """K8's parameter block for one arena and one mirror (the six node
    columns and the const pool checked once), and the mirror's pinned
    staging: two slots, each the size of the largest delta so far rounded
    up to a power of two, so that a refresh allocates nothing once the
    buckets stop growing. A grown staging replaces the old one, which a
    handle still in flight keeps alive through its views."""

    def __init__(self, arena):
        self.capacity, self.const_capacity = (arena.op.shape[0],
                                              arena.const_vals.shape[0])
        values = [0] * Lay.K8_NARGS
        for position, col in enumerate((arena.op, arena.a, arena.b, arena.c,
                                        arena.imm, arena.imm2)):
            values[Lay.K8_COL + position] = _check(col, "arena column",
                                                   torch.int32,
                                                   (self.capacity,))
        values[Lay.K8_CONST_VALS] = _check(arena.const_vals,
                                           "arena.const_vals", torch.int32,
                                           (self.const_capacity, 16))
        self.block = _block("mtpu_arena_delta", values)
        self.device = arena.op.device
        self.staging = None
        self.slot_words = 0
        self.mapped = 0
        self.events = [None, None]
        self.launches = 0

    def launch(self, slot: int, start: int, cstart: int, bucket: int,
               cbucket: int):
        words = 6 * bucket + 16 * cbucket
        if words > self.slot_words:
            self.slot_words = 1 << (words - 1).bit_length()
            self.staging = _pinned_int32(2 * self.slot_words)
            self.mapped = _mapped_address(self.staging)
        base = slot * self.slot_words
        block = self.block
        block[Lay.K8_START] = start
        block[Lay.K8_CSTART] = cstart
        block[Lay.K8_BUCKET] = bucket
        block[Lay.K8_CBUCKET] = cbucket
        block[Lay.K8_OUT_ROWS] = self.mapped + 4 * base
        block[Lay.K8_OUT_CONSTS] = self.mapped + 4 * (base + 6 * bucket)
        self.events[slot] = _launch_after_current(
            "mtpu_arena_delta", block, self.device, self.events[slot])
        self.launches += 1
        LAUNCHES["arena_delta"] += 1
        rows = self.staging[base:base + 6 * bucket].view(6, bucket)
        consts = self.staging[base + 6 * bucket:base + words].view(cbucket, 16)
        return rows, consts, self.events[slot]


_DELTA_PLANS = _Plans(limit=8)


def delta_plan(arena, mirror) -> _DeltaPlan:
    """K8's cached plan for `arena` and the mirror keyed `mirror`."""
    return _DELTA_PLANS.get(
        [arena.op, arena.a, arena.b, arena.c, arena.imm, arena.imm2,
         arena.const_vals], (mirror,), lambda: _DeltaPlan(arena))


def arena_delta(arena, mirror, slot: int, start: int, cstart: int,
                bucket: int, cbucket: int):
    """K8: node rows [start, start+bucket) as int32[6, bucket] and const rows
    [cstart, cstart+cbucket) as int32[cbucket, 16] (both starts clamp so
    the blocks fit), written by one launch on the copy stream, after the
    work queued on the current stream, into staging slot `slot` (0 or 1)
    of the mirror keyed `mirror`. Returns host views of the slot and the
    event after which they hold the blocks; the slot is the caller's to
    keep unused until then."""
    if slot not in (0, 1):
        raise ValueError(f"delta staging slot {slot}")
    plan = delta_plan(arena, mirror)
    cap, ccap = plan.capacity, plan.const_capacity
    if not (0 < bucket <= cap and 0 < cbucket <= ccap):
        raise ValueError(f"delta buckets {bucket}, {cbucket} outside the arena")
    return plan.launch(slot, max(min(int(start), cap - bucket), 0),
                       max(min(int(cstart), ccap - cbucket), 0), bucket,
                       cbucket)


# ---- K10 ----------------------------------------------------------------------------

#: K10's blend families (merge_pass.cu)
_FAMILY_MEM, _FAMILY_STACK, _FAMILY_STORAGE = 0, 1, 2
_FAMILY_FIELDS = ("WANT_CT", "WANT_CF", "WANT_ITE", "VALS_T", "VALS_F",
                  "PRE_T", "PRE_F", "COND", "IDS_CT", "IDS_CF", "IDS_ITE",
                  "OVF_CT", "OVF_CF", "OVF_ITE", "NODE_T", "NODE_F")
#: window columns merge_check holds in shared memory
MAX_MERGE_WINDOWS = 32


def merge_block(state, planes, merge_pcs: torch.Tensor, mem_pcs: torch.Tensor,
                mem_words: torch.Tensor):
    """K10's parameter block for one pass over these lanes and the scratch
    it points at: (values, scratch) with scratch["hashes"] int64[3, B]
    (weak, weak + memory planes, core), "fi"/"ti" int32[B/2] (a round's
    pairs), "stats" and one table dict per blend family."""
    dims = _state_dims(state)
    batch, slots, kslots = dims["B"], dims["S"], dims["K"]
    if batch < 2:
        raise ValueError(f"merge_pass: {batch} lanes, at least 2")
    half = batch // 2
    dev = state.pc.device
    n_tags, n_mem = merge_pcs.shape[0], mem_pcs.shape[0]
    n_wins = mem_words.shape[1]
    if n_wins > MAX_MERGE_WINDOWS or mem_words.shape[0] != n_mem:
        raise ValueError(f"mem_words: {tuple(mem_words.shape)} for {n_mem} "
                         f"pcs, at most {MAX_MERGE_WINDOWS} windows")
    values = [0] * Lay.K10_NARGS
    leaves = list(state) + list(planes)
    values[Lay.K10_LANE:Lay.K10_LANE + Lay.N_ROW_LEAVES] = (
        _leaf_ptrs(state, _STATE_DTYPES, batch, "state")
        + _leaf_ptrs(planes, _PLANE_DTYPES, batch, "planes"))
    values[Lay.K10_ROW_BYTES:Lay.K10_ROW_BYTES + Lay.N_ROW_LEAVES] = [
        leaf[0].numel() * leaf.element_size() for leaf in leaves]
    for slot, value in ((Lay.K10_B, batch), (Lay.K10_S, slots),
                        (Lay.K10_M, dims["M"]), (Lay.K10_K, kslots),
                        (Lay.K10_KC, planes.conds.shape[1]),
                        (Lay.K10_W, n_wins), (Lay.K10_J, n_mem),
                        (Lay.K10_N_TAGS, n_tags)):
        values[slot] = value
    values[Lay.K10_MERGE_PCS] = _check(merge_pcs, "merge_pcs", torch.int32,
                                       (n_tags,))
    values[Lay.K10_MEM_PCS] = _check(mem_pcs, "mem_pcs", torch.int32,
                                     (n_mem,))
    values[Lay.K10_MEM_WORDS] = _check(mem_words, "mem_words", torch.int32)

    def scratch(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    # the sort above 1024 lanes runs over the next power of two in memory
    sort_n = 1 << (batch - 1).bit_length() if batch > 1024 else 0
    values[Lay.K10_SORT_N] = sort_n
    tensors = {"hashes": scratch((3, batch), torch.int64),
               "info": scratch((Lay.N_INFO, batch)),
               "eligible": scratch(batch, torch.bool),
               "fi": scratch(half), "ti": scratch(half),
               "ok": scratch(half, torch.bool),
               "stats": scratch(MERGE_STATS_FIXED + n_tags + N_MERGE_DEPTH,
                                torch.int64),
               "sort_keys": scratch(sort_n, torch.int64),
               "sort_idx": scratch(sort_n)}
    for slot, name in ((Lay.K10_HASH, "hashes"), (Lay.K10_INFO, "info"),
                       (Lay.K10_ELIG, "eligible"), (Lay.K10_FI, "fi"),
                       (Lay.K10_TI, "ti"), (Lay.K10_OK, "ok"),
                       (Lay.K10_STATS, "stats"), (Lay.K10_SORT_KEYS, "sort_keys"),
                       (Lay.K10_SORT_IDX, "sort_idx")):
        values[slot] = tensors[name].data_ptr()
    # one table set per blend family, `half * width` entries each
    for family, width in ((_FAMILY_MEM, max(n_wins, 1)),
                          (_FAMILY_STACK, slots), (_FAMILY_STORAGE, kslots)):
        n = half * width
        table = {}
        for field in _FAMILY_FIELDS:
            if field.startswith(("WANT", "OVF")):
                table[field] = scratch(n, torch.bool)
            elif field.startswith("VALS"):
                table[field] = scratch((n, 16))
            else:
                table[field] = scratch(n)
            values[Lay.K10_FAM + family * Lay.N_FAM_FIELDS
                   + Lay.SLOTS[f"FAM_{field}"]] = table[field].data_ptr()
        tensors[family] = table
    return values, tensors


class _MergePlan:
    """One merge pass's parameter block and scratch for one set of lanes,
    arena and tables: `merge_block`'s, the arena's columns and the folded
    allocations' counts, prefixes and bump pointers."""

    def __init__(self, state, planes, arena, merge_pcs, mem_pcs, mem_words,
                 n_rounds: int):
        if n_rounds < 0:
            raise ValueError(f"merge_pass: {n_rounds} rounds")
        values, self.tensors = merge_block(state, planes, merge_pcs, mem_pcs,
                                           mem_words)
        half = state.pc.shape[0] // 2
        dev = state.pc.device
        self.tensors["alloc"] = [torch.zeros((9, half), dtype=torch.int32,
                                             device=dev) for _ in range(2)] \
            + [torch.zeros((9, 2), dtype=torch.int32, device=dev)]
        for slot, tensor in zip((Lay.K10_ACNT, Lay.K10_APRE, Lay.K10_ABASE),
                                self.tensors["alloc"]):
            values[slot] = tensor.data_ptr()
        cap = arena.op.shape[0]
        for slot, col, what in ((Lay.K10_AR_OP, arena.op, "arena.op"),
                                (Lay.K10_AR_A, arena.a, "arena.a"),
                                (Lay.K10_AR_B, arena.b, "arena.b"),
                                (Lay.K10_AR_C, arena.c, "arena.c"),
                                (Lay.K10_AR_IMM, arena.imm, "arena.imm"),
                                (Lay.K10_AR_IMM2, arena.imm2, "arena.imm2"),
                                (Lay.K10_AR_CLS, arena.cls, "arena.cls")):
            values[slot] = _check(col, what, torch.int32, (cap,))
        values[Lay.K10_AR_CONST] = _check(arena.const_vals, "arena.const_vals",
                                          torch.int32)
        values[Lay.K10_AR_N] = _check(arena.n, "arena.n", torch.int32, ())
        values[Lay.K10_AR_N_CONST] = _check(arena.n_const, "arena.n_const",
                                            torch.int32, ())
        values[Lay.K10_AR_CAP] = cap
        values[Lay.K10_AR_CCAP] = arena.const_vals.shape[0]
        values[Lay.K10_ROUNDS] = n_rounds
        self.block = _block("mtpu_merge_run", values)

    def launch(self) -> None:
        """The whole pass from one host call, its allocations folded in."""
        _call("mtpu_merge_run", self.block)
        LAUNCHES["merge_pass"] += 1
        LAUNCHES["arena_alloc_merge"] += 1


_MERGE_PLANS = _Plans(limit=4)


def merge_pass(state, planes, arena, merge_pcs: torch.Tensor,
               mem_pcs: torch.Tensor, mem_words: torch.Tensor,
               n_rounds: int):
    """K10, K3's allocations folded in: one merge pass, every tensor updated
    in place, any lane count, from one host call that makes every launch
    (its plan built once for these tensors and `n_rounds`). `merge_pcs` int32[K], `mem_pcs` int32[J], `mem_words`
    int32[J, W]. Returns (state, planes, arena, stats int64[8 + K + 6])."""
    plan = _MERGE_PLANS.get(
        list(state) + list(planes) + list(arena)
        + [merge_pcs, mem_pcs, mem_words], (n_rounds,),
        lambda: _MergePlan(state, planes, arena, merge_pcs, mem_pcs,
                           mem_words, n_rounds))
    plan.launch()
    return state, planes, arena, plan.tensors["stats"].clone()


# ---- K11 ----------------------------------------------------------------------------

#: variables per tile of K11's resolve launches on the card: 16 tiles, so
#: 512 blocks for 32 probes at V1 65,536
SAT_VAR_TILE = 4096


class _SatPlan:
    """K11's parameter block and scratch for one state and problem: the
    implied keys, flags and bitmaps (zero, and left zero by every step),
    the assignment's mirror, the tile partials and the branch records."""

    def __init__(self, state, problem, forced_depth: int, freeze: bool,
                 var_tile: int):
        queries = state.assign.shape[:-2]       # () for one query, (Q,) batched
        lead = queries[0] if queries else 1
        n_probes, v1 = state.assign.shape[-2:]
        if n_probes > 1024:
            raise ValueError(f"{n_probes} probes: the kernel takes at most 1024")
        if var_tile < 32 or var_tile & (var_tile - 1):
            raise ValueError(f"var_tile = {var_tile}: a power of two >= 32")
        if problem.valid.dim() != state.assign.dim():
            raise ValueError(f"valid: shape {tuple(problem.valid.shape)} does "
                             f"not match the state's queries")
        tiles = queries + (problem.valid.shape[-2], TILE)
        values = [0] * Lay.K11_NARGS
        for slot, leaf, what, dtype, shape in (
                (Lay.K11_ASSIGN, state.assign, "assign", torch.int8,
                 state.assign.shape),
                (Lay.K11_TRAIL, state.trail, "trail", torch.int32,
                 state.assign.shape),
                (Lay.K11_TAG, state.tag, "tag", torch.int8, state.assign.shape),
                (Lay.K11_TRAIL_LEN, state.trail_len, "trail_len", torch.int32,
                 state.assign.shape[:-1]),
                (Lay.K11_STATUS, state.status, "status", torch.int8,
                 state.assign.shape[:-1]),
                (Lay.K11_LITS, problem.lits, "lits", torch.int32, tiles + (3,)),
                (Lay.K11_VALID, problem.valid, "valid", torch.bool, tiles),
                (Lay.K11_ORDER, problem.order, "order", torch.int32,
                 queries + (v1,))):
            values[slot] = _check(leaf, what, dtype, shape)
        rows = lead * n_probes
        n_tiles = -(-v1 // var_tile)
        dev = state.assign.device

        def scratch(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.scratch = {
            Lay.K11_KEY: scratch(rows, v1),
            Lay.K11_CONFLICT: scratch(rows),
            Lay.K11_UNIT: scratch(rows),
            Lay.K11_BITS: scratch(rows, -(-v1 // 32)),
            Lay.K11_MIRROR: scratch(lead, v1, n_probes, dtype=torch.int8),
            Lay.K11_PART64: scratch(rows, n_tiles, dtype=torch.int64),
            Lay.K11_PART32: scratch(rows, n_tiles, 2),
            Lay.K11_RES: scratch(rows, Lay.N_SAT_RES)}
        if freeze:
            self.scratch[Lay.K11_DECIDED] = scratch(lead)
        for slot, tensor in self.scratch.items():
            values[slot] = tensor.data_ptr()
        for slot, value in ((Lay.K11_Q, lead), (Lay.K11_P, n_probes),
                            (Lay.K11_V1, v1),
                            (Lay.K11_C, problem.valid.numel() // lead),
                            (Lay.K11_FORCED_DEPTH, forced_depth),
                            (Lay.K11_VT, var_tile)):
            values[slot] = value
        self.block = _block("mtpu_sat_run", values)

    def launch(self, steps: int) -> None:
        """One chunk: the mirror, then `steps` steps."""
        self.block[Lay.K11_STEPS] = steps
        _call("mtpu_sat_run", self.block)
        LAUNCHES["sat_step"] += 1


_SAT_PLANS = _Plans(limit=4)
_SAT_GRAPHS = _Plans(limit=4)


def sat_run(state, problem, steps: int, forced_depth: int, freeze: bool,
            graph: bool = True, var_tile: int = SAT_VAR_TILE):
    """K11: `steps` DPLL steps of every probe, in place: one host call, or
    with `graph` one replay of the chunk's CUDA graph (captured once for
    the state's and the problem's tensors, the static arguments and the
    step count). `state` is a device_solver.SolverState
    of one query ([P, V1], [P]) or of a batch ([Q, P, V1], [Q, P]);
    `problem` the matching DeviceProblem. With `freeze`, a query whose
    probes are decided keeps its state (the batch runner). `var_tile`
    variables share a block of the resolve launches. Returns the state."""
    if steps < 0:
        raise ValueError(f"steps = {steps}")
    tensors = list(state) + list(problem)
    static = (forced_depth, freeze, var_tile)
    plan = _SAT_PLANS.get(tensors, static, lambda: _SatPlan(
        state, problem, forced_depth, freeze, var_tile))
    if steps == 0:
        return state
    if graph:
        _replay(_SAT_GRAPHS, tensors, static + (steps,),
                lambda: (lambda: plan.launch(steps)), ("mtpu_sat_preload",),
                "sat_chunk")
    else:
        plan.launch(steps)
    return state


# ---- K13 ----------------------------------------------------------------------------

def _on(device: torch.device):
    """The block's launches and copies on `device` (its current stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _SatShardPlan:
    """K13's shards for one state and problem: for each shard its device,
    its replica of the state (shard 0 on the state's device steps the
    caller's state itself), the problem's tensors on its device (a copy on
    another device), its block of the clause tiles as a clause range,
    K11's step scratch, its exchange planes [D, Q * P * 2 * (ceil(V1 / 32)
    + 1)] and its parameter block. With every shard on the caller's card
    (`one_card`) it also holds a stream a shard and the chunk graphs
    captured on them. The plan holds no tensor of the caller's."""

    def __init__(self, state, problem, forced_depth: int, mesh: tuple,
                 var_tile: int):
        n_shards = len(mesh)
        queries = state.assign.shape[:-2]
        lead = queries[0] if queries else 1
        n_probes, v1 = state.assign.shape[-2:]
        if n_probes > 1024:
            raise ValueError(f"{n_probes} probes: the kernel takes at most 1024")
        if var_tile < 32 or var_tile & (var_tile - 1):
            raise ValueError(f"var_tile = {var_tile}: a power of two >= 32")
        if problem.valid.dim() != state.assign.dim():
            raise ValueError(f"valid: shape {tuple(problem.valid.shape)} does "
                             f"not match the state's queries")
        n_tiles = problem.valid.shape[-2]
        if n_shards < 1 or n_tiles % n_shards:
            raise ValueError(f"{n_tiles} clause tiles do not split over "
                             f"{n_shards} shards")
        tiles = queries + (n_tiles, TILE)
        for leaf, what, dtype, shape in (
                (state.assign, "assign", torch.int8, state.assign.shape),
                (state.trail, "trail", torch.int32, state.assign.shape),
                (state.tag, "tag", torch.int8, state.assign.shape),
                (state.trail_len, "trail_len", torch.int32,
                 state.assign.shape[:-1]),
                (state.status, "status", torch.int8, state.assign.shape[:-1]),
                (problem.lits, "lits", torch.int32, tiles + (3,)),
                (problem.valid, "valid", torch.bool, tiles),
                (problem.order, "order", torch.int32, queries + (v1,))):
            _check(leaf, what, dtype, shape)
        rows = lead * n_probes
        n_words = -(-v1 // 32)
        plane = rows * 2 * (n_words + 1)
        width = n_tiles // n_shards * TILE
        home = state.assign.device
        self.one_card = home.type == "cuda" and all(
            dev == home for dev in mesh + (problem.lits.device,))
        self.streams = ([torch.cuda.Stream(device=home) for _ in mesh]
                        if self.one_card else None)
        self.graphs = _Plans(limit=4)
        self.shards = []
        for index, dev in enumerate(mesh):
            shard = {"device": dev}
            if index == 0 and dev == home:
                leaves = list(state)
            else:
                leaves = shard["replica"] = [
                    torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
                    for leaf in state]
            if dev == problem.lits.device:
                tensors = list(problem)
            else:
                tensors = shard["problem"] = [
                    torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
                    for leaf in problem]

            def scratch(*shape, dtype=torch.int32):
                return torch.zeros(shape, dtype=dtype, device=dev)

            n_var_tiles = -(-v1 // var_tile)
            shard["scratch"] = {
                Lay.K11_KEY: scratch(rows, v1),
                Lay.K11_CONFLICT: scratch(rows),
                Lay.K11_UNIT: scratch(rows),
                Lay.K11_BITS: scratch(rows, n_words),
                Lay.K11_MIRROR: scratch(lead, v1, n_probes, dtype=torch.int8),
                Lay.K11_PART64: scratch(rows, n_var_tiles, dtype=torch.int64),
                Lay.K11_PART32: scratch(rows, n_var_tiles, 2),
                Lay.K11_RES: scratch(rows, Lay.N_SAT_RES),
                Lay.K11_XCHG: scratch(n_shards, plane)}
            values = [0] * Lay.K11_NARGS
            for slot, tensor in zip(
                    (Lay.K11_ASSIGN, Lay.K11_TRAIL, Lay.K11_TAG,
                     Lay.K11_TRAIL_LEN, Lay.K11_STATUS, Lay.K11_LITS,
                     Lay.K11_VALID, Lay.K11_ORDER), leaves + tensors):
                values[slot] = tensor.data_ptr()
            for slot, tensor in shard["scratch"].items():
                values[slot] = tensor.data_ptr()
            for slot, value in ((Lay.K11_Q, lead), (Lay.K11_P, n_probes),
                                (Lay.K11_V1, v1), (Lay.K11_C, n_tiles * TILE),
                                (Lay.K11_C0, index * width),
                                (Lay.K11_C1, (index + 1) * width),
                                (Lay.K11_FORCED_DEPTH, forced_depth),
                                (Lay.K11_VT, var_tile),
                                (Lay.K11_SHARDS, n_shards),
                                (Lay.K11_SHARD, index)):
                values[slot] = value
            shard["block_values"] = _block("mtpu_sat_shard_propagate", values)
            self.shards.append(shard)
        # the problem tensors last copied to the other devices (weak: a
        # solve never writes its problem, so a copy holds until the caller
        # passes other tensors, which may lie at the same addresses)
        self.copied = ()

    def replicas(self, state) -> list:
        """Every shard's state: the caller's for a shard that steps it."""
        return [shard.get("replica", list(state)) for shard in self.shards]

    def planes(self) -> list:
        """Every shard's exchange planes [D, N_XCHG] (layout.cuh K11_XCHG)."""
        return [shard["scratch"][Lay.K11_XCHG] for shard in self.shards]

    def _chunk(self, state, steps: int, streams) -> None:
        """A chunk's work after the problem's copies: every shard's replica
        refreshed from the caller's state and its mirror, `steps` steps,
        and the caller's state taking shard 0's replica where it has one.
        With `streams` (a stream a shard, all on the caller's card) each
        shard's launches and incoming copies run on its own stream, forked
        from the current stream and joined into it, ordered by events: a
        shard's copies wait for the other shards' seals, and its next seal
        for the other shards' copies of its plane. Without, each shard's
        work runs on its device's current stream, and PyTorch orders each
        copy between devices against both devices' streams. The two
        schemes stay apart until a host with several cards can test the
        streams and events across devices: only the one-card scheme is
        captured, and the eager one is what a mesh of cards ran before."""
        shards = self.shards
        planes = self.planes()
        if streams is None:
            def on(index):
                return _on(shards[index]["device"])
        else:
            def on(index):
                return torch.cuda.stream(streams[index])
            origin = torch.cuda.current_stream()
            for stream in streams:
                stream.wait_stream(origin)
            sealed = [torch.cuda.Event() for _ in shards]
            copied = [torch.cuda.Event() for _ in shards]
        for index, shard in enumerate(shards):
            with on(index):
                for copy, leaf in zip(shard.get("replica", ()), state):
                    copy.copy_(leaf)
                _call("mtpu_sat_shard_mirror", shard["block_values"])
        for step in range(steps):
            for index, shard in enumerate(shards):
                with on(index):
                    if streams is not None and step:
                        for other in range(len(shards)):
                            if other != index:
                                streams[index].wait_event(copied[other])
                    _call("mtpu_sat_shard_propagate", shard["block_values"])
                    if streams is not None:
                        sealed[index].record(streams[index])
            for index, shard in enumerate(shards):
                with on(index):
                    for other in range(len(shards)):
                        if other != index:
                            if streams is not None:
                                streams[index].wait_event(sealed[other])
                            planes[index][other].copy_(planes[other][other])
                    if streams is not None:
                        copied[index].record(streams[index])
                    _call("mtpu_sat_shard_resolve", shard["block_values"])
        if streams is not None:
            for stream in streams:
                origin.wait_stream(stream)
        if "replica" in shards[0]:
            with _on(state.assign.device):
                for leaf, value in zip(state, shards[0]["replica"]):
                    leaf.copy_(value)
        LAUNCHES["sat_step"] += 1
        LAUNCHES["sat_shard_combine"] += 1

    def launch(self, state, problem, steps: int, graph: bool) -> None:
        """One chunk: the problem's copies refreshed from the caller's
        problem when it is other tensors than the last chunk's, then the
        chunk (`_chunk`): with `graph` and `one_card`, one replay of the
        chunk's CUDA graph, captured on the plan's streams for these
        tensors and the step count; else eager host calls, a step at a
        time."""
        fresh = len(self.copied) != len(problem) or any(
            ref() is not leaf for ref, leaf in zip(self.copied, problem))
        if fresh:
            for shard in self.shards:
                with _on(shard["device"]):
                    for copy, leaf in zip(shard.get("problem", ()), problem):
                        copy.copy_(leaf)
        self.copied = tuple(weakref.ref(leaf) for leaf in problem)
        if graph and self.one_card:
            _replay(self.graphs, list(state) + list(problem), (steps,),
                    lambda: (lambda: self._chunk(state, steps, self.streams)),
                    ("mtpu_sat_preload",), "sat_shard_chunk")
        else:
            self._chunk(state, steps, None)


_SAT_SHARD_PLANS = _Plans(limit=2)


def sat_run_sharded(state, problem, steps: int, forced_depth: int,
                    mesh: tuple, var_tile: int = SAT_VAR_TILE,
                    graph: bool = True):
    """K13: `steps` DPLL steps of every probe over the clause shards of
    `mesh` (one a device; a device may repeat), in place, as JAX
    `_get_sharded_runner`. A step is every shard's gate, propagate and
    seal, the exchange planes' copies to every shard, and every shard's
    combine, count and apply. With every shard on the state's card and
    `graph`, the chunk is one replay of its CUDA graph (captured once for
    these tensors, arguments and step count; a shard a stream); otherwise
    (`graph=False`, or a mesh of several devices) eager host calls, a
    step at a time. A failed capture or replay raises. `state` and
    `problem` as `sat_run`'s (no freeze: the JAX package never shards a
    batch); the tiles must divide over the mesh. Returns the state."""
    if steps < 0:
        raise ValueError(f"steps = {steps}")
    mesh = tuple(torch.device(dev) for dev in mesh)
    tensors = list(state) + list(problem)
    static = (forced_depth, var_tile, mesh)
    plan = _SAT_SHARD_PLANS.get(tensors, static, lambda: _SatShardPlan(
        state, problem, forced_depth, mesh, var_tile))
    if steps:
        plan.launch(state, problem, steps, graph)
    return state


def _sat_shard_plan(state, problem, forced_depth: int, mesh: tuple,
                    var_tile: int) -> _SatShardPlan:
    mesh = tuple(torch.device(dev) for dev in mesh)
    plan = _SAT_SHARD_PLANS.plans.get(_key(list(state) + list(problem),
                                           (forced_depth, var_tile, mesh)))
    if plan is None:
        raise KeyError("no sharded chunk ran on these tensors")
    return plan


def sat_shard_replicas(state, problem, forced_depth: int, mesh: tuple,
                       var_tile: int = SAT_VAR_TILE) -> list:
    """Every shard's state after the last `sat_run_sharded` of these
    tensors and arguments (the plan's replicas; the caller's state for a
    shard that steps it)."""
    return _sat_shard_plan(state, problem, forced_depth, mesh,
                           var_tile).replicas(state)


def sat_shard_planes(state, problem, forced_depth: int, mesh: tuple,
                     var_tile: int = SAT_VAR_TILE) -> list:
    """Every shard's exchange planes after the last `sat_run_sharded` of
    these tensors and arguments: int32 [D, Q * P * 2 * (ceil(V1 / 32) +
    1)] a shard, each plane the keyed-var bitmap words [Q * P, NW], the
    FALSE-phase bitmap words [Q * P, NW] (a var's bit set where the
    shard's highest clause keying it implies FALSE), the conflict and the
    unit flags [Q * P] each. A shard's seal writes its own plane whole
    each step; the other slots hold the copies of the last step's."""
    return _sat_shard_plan(state, problem, forced_depth, mesh,
                           var_tile).planes()


# ---- K12 ----------------------------------------------------------------------------

def _steal_tensors(state, sched) -> list:
    """Every tensor K12's cached plan reads or writes: the pool's leaves,
    the lane status, the tops and the steal counters."""
    return (list(sched.stack_state) + list(sched.stack_planes)
            + [state.status, sched.stack_top, sched.steals_sent,
               sched.steals_received, sched.steal_rows])


class _StealPlan:
    """K12's parameter block for one pool, lane status and `max_rows`: the
    pool's leaves and row bytes, K4's row copy plan (`_copy_plan`) and the
    move list (int32[D/2, 3], written by the plan launch)."""

    def __init__(self, state, sched, max_rows: int):
        n_seg = n_segments(sched)
        batch = state.status.shape[0]
        pool_rows = sched.stack_state.status.shape[0]
        if not 2 <= n_seg <= 1024 or batch < n_seg or batch % n_seg \
                or pool_rows % n_seg:
            raise ValueError(f"steal_pass: {n_seg} shards for {batch} lanes and "
                             f"{pool_rows} stack rows")
        if max_rows < 1:
            raise ValueError(f"steal_pass: max_rows = {max_rows}")
        values = [0] * Lay.K12_NARGS
        leaves = list(sched.stack_state) + list(sched.stack_planes)
        values[Lay.K12_POOL:Lay.K12_POOL + Lay.N_ROW_LEAVES] = (
            _leaf_ptrs(sched.stack_state, _STATE_DTYPES, pool_rows, "pool")
            + _leaf_ptrs(sched.stack_planes, _PLANE_DTYPES, pool_rows, "pool"))
        row_bytes = [math.prod(leaf.shape[1:]) * leaf.element_size()
                     for leaf in leaves]
        values[Lay.K12_ROW_BYTES:Lay.K12_ROW_BYTES + Lay.N_ROW_LEAVES] = row_bytes
        values[Lay.K12_STATUS] = _check(state.status, "status", torch.int32,
                                        (batch,))
        values[Lay.K12_STACK_TOP] = _check(sched.stack_top, "stack_top",
                                           torch.int32, (n_seg,))
        values[Lay.K12_STEALS_SENT] = _check(sched.steals_sent, "steals_sent",
                                             torch.int64, (n_seg,))
        values[Lay.K12_STEALS_RECEIVED] = _check(
            sched.steals_received, "steals_received", torch.int64, (n_seg,))
        values[Lay.K12_STEAL_ROWS] = _check(sched.steal_rows, "steal_rows",
                                            torch.int64, ())
        dev = state.status.device
        # the copy plan goes up from pinned pages without a host wait, so
        # that even a plan's first pass reads nothing back
        entries, items = _copy_plan(row_bytes, "cpu")
        self.entries, self.items = (
            t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
            for t in (entries, items))
        self.moves = torch.zeros((n_seg // 2, 3), dtype=torch.int32, device=dev)
        for slot, value in ((Lay.K12_B, batch), (Lay.K12_D, n_seg),
                            (Lay.K12_P, pool_rows), (Lay.K12_MAX_ROWS, max_rows),
                            (Lay.K12_MOVES, self.moves.data_ptr()),
                            (Lay.K12_ENTRIES, self.entries.data_ptr()),
                            (Lay.K12_ITEMS, self.items.data_ptr()),
                            (Lay.K12_N_ITEMS, self.items.shape[0] - 1)):
            values[slot] = value
        self.block = _block("mtpu_steal_pass", values)

    def launch(self, min_imbalance: int) -> None:
        """One pass: the plan launch and the move launch, from one host
        call."""
        self.block[Lay.K12_MIN_IMBALANCE] = min_imbalance
        _call("mtpu_steal_pass", self.block)
        LAUNCHES["steal_pass"] += 1


_STEAL_PLANS = _Plans(limit=4)


def steal_pass(state, sched, min_imbalance: int, max_rows: int):
    """K12: one steal pass of a sharded scheduler, in place: the plan launch
    (loads, pairing, move list, tops and counters) and the move launch (the
    listed pool rows over K4's row copy plan), from a plan cached for
    these tensors and `max_rows`. Only `min_imbalance` comes from the host; nothing is read
    back. Returns the scheduler."""
    _check(state.status, "status", torch.int32)
    plan = _STEAL_PLANS.get(_steal_tensors(state, sched), (max_rows,),
                            lambda: _StealPlan(state, sched, max_rows))
    plan.launch(min_imbalance)
    return sched


def steal_pass_grid() -> tuple:
    """(plan blocks, plan threads, move blocks, move threads) of the last
    steal pass, as its launches recorded them."""
    return _grid("mtpu_steal_grid", 4)
