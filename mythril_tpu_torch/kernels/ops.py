"""Thin PyTorch wrappers around the hand-written CUDA kernels K1-K11.

Each wrapper checks device, dtype, shape and contiguity, allocates what the
kernel writes with `torch.empty`, fills the kernel's parameter block (slot
indices from layout.cuh), launches on `torch.cuda.current_stream()` and
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

A count is per wrapper call: K4's call makes four device launches of its
own (K9 counts the calls that run its TEL instantiation), K6 counts its
three entries together, K7 its two, and K10 one per pass, whatever its
rounds launch (its K3 allocations count as K3's). K11 counts one per
chunk: its call runs every step of the chunk (two launches a step, three
with the batch runner's freeze).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from . import build, layout as Lay
from ..parallel.device_solver import TILE
from ..parallel.symstep import (ITE_OP, MAX_TEL_SLOTS, MERGE_STATS_FIXED,
                                N_MERGE_DEPTH)

#: launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"keccak": 0, "evm_step": 0, "arena_alloc": 0,
                            "sym_step": 0, "telemetry": 0,
                            "frontier_summary": 0, "pack_rows": 0,
                            "gather_rows": 0, "arena_delta": 0,
                            "merge_pass": 0, "sat_step": 0}

#: which source each exported entry point lives in
_ENTRY_LIB = {"mtpu_keccak_rows": "keccak", "mtpu_sha_prep": "evm_step",
              "mtpu_evm_step": "evm_step", "mtpu_arena_alloc": "arena_alloc",
              "mtpu_sym_pre": "sym_step", "mtpu_sym_mid1": "sym_step",
              "mtpu_sym_mid2": "sym_step", "mtpu_sym_post": "sym_step",
              "mtpu_sym_pre_tel": "sym_step", "mtpu_sym_post_tel": "sym_step",
              "mtpu_frontier_summary": "frontier_summary",
              "mtpu_row_maxima": "pack_rows", "mtpu_pack_rows": "pack_rows",
              "mtpu_reset_esc": "pack_rows",
              "mtpu_gather_rows": "gather_rows",
              "mtpu_scatter_rows": "gather_rows",
              "mtpu_arena_delta": "arena_delta",
              "mtpu_merge_hash": "merge_pass", "mtpu_merge_pair": "merge_pass",
              "mtpu_merge_check": "merge_pass",
              "mtpu_merge_nodes": "merge_pass",
              "mtpu_merge_apply": "merge_pass",
              "mtpu_merge_blocked": "merge_pass",
              "mtpu_sat_run": "sat_step"}
_FUNCS: Dict[str, object] = {}
_OPTABS: Dict[str, torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _entry(name: str):
    if name not in _FUNCS:
        fn = getattr(build.load(_ENTRY_LIB[name]), name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return _FUNCS[name]


def _launch(name: str, values) -> None:
    if len(values) > Lay.MTPU_MAX_ARGS:
        raise ValueError(f"{name}: {len(values)} argument slots")
    block = (ctypes.c_longlong * len(values))(*[int(v) for v in values])
    stream = torch.cuda.current_stream().cuda_stream
    rc = _entry(name)(ctypes.cast(block, ctypes.c_void_p), len(values),
                      ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


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

def keccak_rows(data: torch.Tensor, length: torch.Tensor,
                offset: Optional[torch.Tensor] = None,
                limit: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: digest of row i of data[B, n] read from offset[i] (0 if absent)
    for length[i] bytes, bytes at or past limit[i] (n if absent) reading 0;
    rows whose mask is False get a zero digest."""
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


def evm_step(state, force_escape: Optional[torch.Tensor] = None,
             force_fork: Optional[torch.Tensor] = None):
    """K2 (with K1 for SHA3 lanes): one instruction for every lane, in
    place. Returns the same StateBatch."""
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
    sha_off = torch.empty(batch, dtype=torch.int64, device=dev)
    sha_len = torch.empty(batch, dtype=torch.int32, device=dev)
    sha_mask = torch.empty(batch, dtype=torch.bool, device=dev)
    values[Lay.K2_SHA_OFF] = sha_off.data_ptr()
    values[Lay.K2_SHA_LEN] = sha_len.data_ptr()
    values[Lay.K2_SHA_MASK] = sha_mask.data_ptr()
    _launch("mtpu_sha_prep", values)
    digest = keccak_rows(state.memory, sha_len, offset=sha_off,
                         limit=state.msize, mask=sha_mask)
    values[Lay.K2_DIGEST] = digest.data_ptr()
    _launch("mtpu_evm_step", values)
    LAUNCHES["evm_step"] += 1
    return state


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

def sym_step(state, planes, arena, sched):
    """K4 around K2 (and K1) and four K3 allocations: one symbolic step
    for every lane, every tensor updated in place. With the telemetry plane
    armed, sym_pre and sym_post are their TEL instantiations (K9), which
    also count into the plane."""
    dims = _state_dims(state)
    batch = dims["B"]
    if batch > 1024:
        raise ValueError("sym_step scans in one block: at most 1024 lanes")
    dev = state.stack.device
    lane_ptrs = (_leaf_ptrs(state, _STATE_DTYPES, batch, "state")
                 + _leaf_ptrs(planes, _PLANE_DTYPES, batch, "planes"))
    pool_rows = sched.stack_state.stack.shape[0]
    esc_rows = sched.esc_state.stack.shape[0]
    pool_ptrs = (_leaf_ptrs(sched.stack_state, _STATE_DTYPES, pool_rows, "pool")
                 + _leaf_ptrs(sched.stack_planes, _PLANE_DTYPES, pool_rows, "pool"))
    esc_ptrs = (_leaf_ptrs(sched.esc_state, _STATE_DTYPES, esc_rows, "esc")
                + _leaf_ptrs(sched.esc_planes, _PLANE_DTYPES, esc_rows, "esc"))
    row_bytes = []
    for lane_leaf, pool_leaf, esc_leaf in zip(
            list(state) + list(planes),
            list(sched.stack_state) + list(sched.stack_planes),
            list(sched.esc_state) + list(sched.esc_planes)):
        if lane_leaf.shape[1:] != pool_leaf.shape[1:] \
                or lane_leaf.shape[1:] != esc_leaf.shape[1:]:
            raise ValueError("scheduler rows do not match the lane rows")
        row_bytes.append(lane_leaf[0].numel() * lane_leaf.element_size())

    iscr = torch.empty((Lay.N_ISCR, batch), dtype=torch.int32, device=dev)
    fscr = torch.zeros((Lay.N_FSCR, batch), dtype=torch.bool, device=dev)
    wscr = torch.empty((Lay.N_WSCR, batch, 16), dtype=torch.int32, device=dev)

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
                        (Lay.K4_PRED_MASK, PREDICTABLE_MASK)):
        values[slot] = value
    values[Lay.K4_CLS] = _check(arena.cls, "arena.cls", torch.int32)
    for slot, tensor, dtype in (
            (Lay.K4_STACK_TOP, sched.stack_top, torch.int32),
            (Lay.K4_ESC_COUNT, sched.esc_count, torch.int32),
            (Lay.K4_EXECUTED, sched.executed, torch.int64),
            (Lay.K4_FORKS, sched.forks, torch.int64),
            (Lay.K4_PUSHES, sched.pushes, torch.int64),
            (Lay.K4_POPS, sched.pops, torch.int64),
            (Lay.K4_ENABLED, sched.enabled, torch.bool)):
        values[slot] = _check(tensor, "scheduler scalar", dtype, ())
    values[Lay.K4_OPTAB] = optab(dev).data_ptr()
    values[Lay.K4_ISCR] = iscr.data_ptr()
    values[Lay.K4_FSCR] = fscr.data_ptr()
    values[Lay.K4_WSCR] = wscr.data_ptr()
    tel = sched.telemetry
    suffix = ""
    if tel is not None:
        suffix = "_tel"
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

    _launch("mtpu_sym_pre" + suffix, values)
    evm_step(state, fscr[Lay.F_FORCE_ESCAPE], fscr[Lay.F_FORCE_FORK])
    _launch("mtpu_sym_mid1", values)
    arena_alloc(arena, fscr[Lay.F_WANT_CA], wscr[Lay.W_A],
                out_ids=iscr[Lay.I_IDS_CA], out_ovf=fscr[Lay.F_OVF_CA])
    arena_alloc(arena, fscr[Lay.F_WANT_CB], wscr[Lay.W_B],
                out_ids=iscr[Lay.I_IDS_CB], out_ovf=fscr[Lay.F_OVF_CB])
    _launch("mtpu_sym_mid2", values)
    arena_alloc(arena, fscr[Lay.F_WANT_R], op=iscr[Lay.I_OP],
                a=iscr[Lay.I_NODE_A], b=iscr[Lay.I_NODE_B],
                c=iscr[Lay.I_ZERO], imm=iscr[Lay.I_ZERO],
                imm2=iscr[Lay.I_PRE_PC],
                out_ids=iscr[Lay.I_IDS_R], out_ovf=fscr[Lay.F_OVF_R])
    arena_alloc(arena, fscr[Lay.F_WANT_E], op=iscr[Lay.I_VAR_OP],
                a=iscr[Lay.I_ZERO], b=iscr[Lay.I_ZERO], c=iscr[Lay.I_ZERO],
                imm=iscr[Lay.I_VAR_CLASS], imm2=iscr[Lay.I_VAR_QUAL],
                out_ids=iscr[Lay.I_IDS_E], out_ovf=fscr[Lay.F_OVF_E])
    _launch("mtpu_sym_post" + suffix, values)
    LAUNCHES["sym_step"] += 1
    if tel is not None:
        LAUNCHES["telemetry"] += 1
    return state, planes, arena, sched


# ---- K5 -----------------------------------------------------------------------------

def _tel_parts(tel, *slots):
    """(slot, counter tensor, length) of the plane's int64 counters, in
    `telemetry_words` order, for the given parameter slots."""
    counters = (tel.op_hist, tel.lifecycle, tel.esc_cause, tel.occupancy,
                tel.hwm, tel.tag_occ, tel.fleet_occ)
    return [(slot, tensor, tensor.shape[0])
            for slot, tensor in zip(slots, counters)]


def frontier_summary(state, planes, arena, sched) -> torch.Tensor:
    """K5: the chunk summary int64[13 + 3B], then the telemetry words when
    the plane is armed (single-shard scheduler; the caller checks)."""
    batch = state.status.shape[0]
    esc_rows, slots = sched.esc_state.storage_used.shape
    values = [0] * Lay.K5_NARGS
    for slot, tensor, what in ((Lay.K5_STATUS, state.status, "status"),
                               (Lay.K5_FORK_COND, planes.fork_cond, "fork_cond"),
                               (Lay.K5_CTX_ID, planes.ctx_id, "ctx_id")):
        values[slot] = _check(tensor, what, torch.int32, (batch,))
    for slot, tensor, dtype in (
            (Lay.K5_STACK_TOP, sched.stack_top, torch.int32),
            (Lay.K5_ESC_COUNT, sched.esc_count, torch.int32),
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
    out = torch.empty(n_words, dtype=torch.int64, device=state.status.device)
    values[Lay.K5_OUT] = out.data_ptr()
    _launch("mtpu_frontier_summary", values)
    LAUNCHES["frontier_summary"] += 1
    return out


# ---- K6 -----------------------------------------------------------------------------

def _row_source(state_like, planes_like, index) -> list:
    """K6's parameter block with the source rows and the index filled."""
    rows = state_like.status.shape[0]
    n = index.shape[0]
    if n == 0:
        raise ValueError("index: no rows selected")
    values = [0] * Lay.K6_NARGS
    values[Lay.K6_LEAF:Lay.K6_LEAF + Lay.N_ROW_LEAVES] = (
        _leaf_ptrs(state_like, _STATE_DTYPES, rows, "rows")
        + _leaf_ptrs(planes_like, _PLANE_DTYPES, rows, "rows"))
    values[Lay.K6_INDEX] = _check(index, "index", torch.int32, (n,))
    values[Lay.K6_N] = n
    values[Lay.K6_ROWS] = rows
    values[Lay.K6_S] = state_like.stack.shape[1]
    values[Lay.K6_M] = state_like.memory.shape[1]
    values[Lay.K6_K] = state_like.storage_keys.shape[1]
    values[Lay.K6_KC] = planes_like.conds.shape[1]
    return values


def row_maxima(state_like, planes_like, index: torch.Tensor) -> torch.Tensor:
    """K6 `row_maxima`: int64[4] maxima of msize, sp, used storage slots
    and cond_count over the rows of `index`."""
    values = _row_source(state_like, planes_like, index)
    out = torch.empty(4, dtype=torch.int64, device=index.device)
    values[Lay.K6_OUT_MAXIMA] = out.data_ptr()
    _launch("mtpu_row_maxima", values)
    LAUNCHES["pack_rows"] += 1
    return out


def pack_rows(state_like, planes_like, index: torch.Tensor, mem_b: int,
              sp_b: int, st_b: int, conds_w: int):
    """K6 `pack_rows`: the rows of `index` packed into (int32, uint8, int64)
    flat blocks at the widths given."""
    values = _row_source(state_like, planes_like, index)
    for name, width, cap in (("mem_b", mem_b, values[Lay.K6_M]),
                             ("sp_b", sp_b, values[Lay.K6_S]),
                             ("st_b", st_b, values[Lay.K6_K]),
                             ("conds_w", conds_w, values[Lay.K6_KC])):
        if not 0 <= width <= cap:
            raise ValueError(f"{name} = {width} outside [0, {cap}]")
    n = index.shape[0]
    dev = index.device
    i32 = torch.empty(n * (8 + 16 * sp_b + 32 * st_b + sp_b + mem_b + st_b
                           + conds_w), dtype=torch.int32, device=dev)
    u8 = torch.empty(n * (mem_b + 2 * st_b), dtype=torch.uint8, device=dev)
    gas = torch.empty(n, dtype=torch.int64, device=dev)
    values[Lay.K6_MEM_B] = mem_b
    values[Lay.K6_SP_B] = sp_b
    values[Lay.K6_ST_B] = st_b
    values[Lay.K6_CONDS_W] = conds_w
    values[Lay.K6_OUT_I32] = i32.data_ptr()
    values[Lay.K6_OUT_U8] = u8.data_ptr()
    values[Lay.K6_OUT_GAS] = gas.data_ptr()
    _launch("mtpu_pack_rows", values)
    LAUNCHES["pack_rows"] += 1
    return i32, u8, gas


def reset_esc(sched):
    """K6 `reset_esc`: the scheduler's escape count to 0, in place."""
    values = [0] * Lay.K6_NARGS
    values[Lay.K6_ESC_COUNT] = _check(sched.esc_count, "esc_count",
                                      torch.int32, ())
    _launch("mtpu_reset_esc", values)
    LAUNCHES["pack_rows"] += 1
    return sched


# ---- K7 -----------------------------------------------------------------------------

def _rows_call(entry: str, src_trees, dst_trees, index, src_rows, dst_rows):
    leaves_src = [leaf for tree in src_trees for leaf in tree]
    leaves_dst = [leaf for tree in dst_trees for leaf in tree]
    n = index.shape[0]
    values = [0] * Lay.K7_NARGS
    values[Lay.K7_SRC:Lay.K7_SRC + Lay.N_ROW_LEAVES] = (
        _leaf_ptrs(src_trees[0], _STATE_DTYPES, src_rows, "src")
        + _leaf_ptrs(src_trees[1], _PLANE_DTYPES, src_rows, "src"))
    values[Lay.K7_DST:Lay.K7_DST + Lay.N_ROW_LEAVES] = (
        _leaf_ptrs(dst_trees[0], _STATE_DTYPES, dst_rows, "dst")
        + _leaf_ptrs(dst_trees[1], _PLANE_DTYPES, dst_rows, "dst"))
    for position, (src, dst) in enumerate(zip(leaves_src, leaves_dst)):
        if src.shape[1:] != dst.shape[1:] or src.dtype != dst.dtype:
            raise ValueError("source and destination rows differ")
        values[Lay.K7_ROW_BYTES + position] = \
            int(np.prod(src.shape[1:])) * src.element_size()
    values[Lay.K7_INDEX] = _check(index, "index", torch.int32, (n,))
    values[Lay.K7_N] = n
    values[Lay.K7_SRC_ROWS] = src_rows
    values[Lay.K7_DST_ROWS] = dst_rows
    _launch(entry, values)
    LAUNCHES["gather_rows"] += 1


def gather_rows(state, planes, index: torch.Tensor):
    """K7 gather: the rows of `index` of every leaf, as new (StateBatch,
    SymPlanes)."""
    n = index.shape[0]
    if n == 0:
        raise ValueError("index: no rows selected")
    rows = [type(tree)(*[torch.empty((n,) + tuple(leaf.shape[1:]),
                                     dtype=leaf.dtype, device=leaf.device)
                         for leaf in tree]) for tree in (state, planes)]
    _rows_call("mtpu_gather_rows", (state, planes), rows, index,
               state.status.shape[0], n)
    return rows[0], rows[1]


def scatter_rows(state, planes, index: torch.Tensor, rows_state, rows_planes):
    """K7 scatter: row i of (rows_state, rows_planes) to lane index[i] of
    every leaf, in place; indices outside [0, lanes) are dropped."""
    n = index.shape[0]
    if n == 0:
        raise ValueError("index: no rows selected")
    _rows_call("mtpu_scatter_rows", (rows_state, rows_planes), (state, planes),
               index, n, state.status.shape[0])
    return state, planes


# ---- K8 -----------------------------------------------------------------------------

def arena_delta(arena, start: int, cstart: int, bucket: int, cbucket: int):
    """K8: node rows [start, start+bucket) as int32[6, bucket] and const rows
    [cstart, cstart+cbucket) as int32[cbucket, 16]; both starts clamp so the
    blocks fit."""
    cap, ccap = arena.op.shape[0], arena.const_vals.shape[0]
    if not (0 < bucket <= cap and 0 < cbucket <= ccap):
        raise ValueError(f"delta buckets {bucket}, {cbucket} outside the arena")
    values = [0] * Lay.K8_NARGS
    for position, col in enumerate((arena.op, arena.a, arena.b, arena.c,
                                    arena.imm, arena.imm2)):
        values[Lay.K8_COL + position] = _check(col, "arena column",
                                               torch.int32, (cap,))
    values[Lay.K8_CONST_VALS] = _check(arena.const_vals, "arena.const_vals",
                                       torch.int32, (ccap, 16))
    values[Lay.K8_START] = max(min(int(start), cap - bucket), 0)
    values[Lay.K8_CSTART] = max(min(int(cstart), ccap - cbucket), 0)
    values[Lay.K8_BUCKET] = bucket
    values[Lay.K8_CBUCKET] = cbucket
    dev = arena.op.device
    rows = torch.empty((6, bucket), dtype=torch.int32, device=dev)
    consts = torch.empty((cbucket, 16), dtype=torch.int32, device=dev)
    values[Lay.K8_OUT_ROWS] = rows.data_ptr()
    values[Lay.K8_OUT_CONSTS] = consts.data_ptr()
    _launch("mtpu_arena_delta", values)
    LAUNCHES["arena_delta"] += 1
    return rows, consts


# ---- K10 ----------------------------------------------------------------------------

#: K10's merge modes and blend families (merge_pass.cu)
_STRICT, _WIDEN, _BLOCKED = 0, 1, 2
_FAMILY_MEM, _FAMILY_STACK, _FAMILY_STORAGE = 0, 1, 2
_FAMILY_FIELDS = ("WANT_CT", "WANT_CF", "WANT_ITE", "VALS_T", "VALS_F",
                  "PRE_T", "PRE_F", "COND", "IDS_CT", "IDS_CF", "IDS_ITE",
                  "OVF_CT", "OVF_CF", "OVF_ITE", "NODE_T", "NODE_F")
#: window columns merge_check holds in shared memory
MAX_MERGE_WINDOWS = 32


def merge_pass(state, planes, arena, merge_pcs: torch.Tensor,
               mem_pcs: torch.Tensor, mem_words: torch.Tensor,
               n_rounds: int):
    """K10 around K3: one merge pass, every tensor updated in place.
    `merge_pcs` int32[K], `mem_pcs` int32[J], `mem_words` int32[J, W].
    Returns (state, planes, arena, stats int64[8 + K + 6])."""
    dims = _state_dims(state)
    batch, slots, kslots = dims["B"], dims["S"], dims["K"]
    if not 2 <= batch <= 1024:
        raise ValueError("merge_pass pairs in one block: 2 to 1024 lanes")
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

    hashes = scratch((3, batch), torch.int64)
    lane_info = scratch((Lay.N_INFO, batch))
    eligible = scratch(batch, torch.bool)
    fi, ti = scratch(half), scratch(half)
    ok = scratch(half, torch.bool)
    stats = scratch(MERGE_STATS_FIXED + n_tags + N_MERGE_DEPTH, torch.int64)
    for slot, tensor in ((Lay.K10_HASH, hashes), (Lay.K10_INFO, lane_info),
                         (Lay.K10_ELIG, eligible), (Lay.K10_FI, fi),
                         (Lay.K10_TI, ti), (Lay.K10_OK, ok),
                         (Lay.K10_STATS, stats)):
        values[slot] = tensor.data_ptr()
    # one table set per blend family, `half * width` entries each
    families = {}
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
        families[family] = table
    n_max = half * max(n_wins, slots, kslots, 1)
    ite_ops = torch.full((n_max,), ITE_OP, dtype=torch.int32, device=dev)
    zeros = scratch(n_max)

    def blend(family):
        table = families[family]
        n = table["COND"].shape[0]
        arena_alloc(arena, table["WANT_CT"], table["VALS_T"],
                    out_ids=table["IDS_CT"], out_ovf=table["OVF_CT"])
        arena_alloc(arena, table["WANT_CF"], table["VALS_F"],
                    out_ids=table["IDS_CF"], out_ovf=table["OVF_CF"])
        values[Lay.K10_FAMILY] = family
        _launch("mtpu_merge_nodes", values)
        arena_alloc(arena, table["WANT_ITE"], None, op=ite_ops[:n],
                    a=table["COND"], b=table["NODE_T"], c=table["NODE_F"],
                    imm=zeros[:n], imm2=zeros[:n], out_ids=table["IDS_ITE"],
                    out_ovf=table["OVF_ITE"])

    _launch("mtpu_merge_hash", values)
    for mode in (_STRICT, _WIDEN) if n_mem else (_STRICT,):
        for round_ in range(n_rounds):
            values[Lay.K10_MODE] = mode
            values[Lay.K10_SHIFT] = round_ % 2
            _launch("mtpu_merge_pair", values)
            _launch("mtpu_merge_check", values)
            if mode == _WIDEN:
                blend(_FAMILY_MEM)
            blend(_FAMILY_STACK)
            blend(_FAMILY_STORAGE)
            _launch("mtpu_merge_apply", values)
    values[Lay.K10_MODE] = _BLOCKED
    values[Lay.K10_SHIFT] = 0
    _launch("mtpu_merge_pair", values)
    _launch("mtpu_merge_blocked", values)
    LAUNCHES["merge_pass"] += 1
    return state, planes, arena, stats


# ---- K11 ----------------------------------------------------------------------------

def sat_run(state, problem, steps: int, forced_depth: int, freeze: bool):
    """K11: `steps` DPLL steps of every probe, in place, from one host call.
    `state` is a device_solver.SolverState of one query ([P, V1], [P]) or
    of a batch ([Q, P, V1], [Q, P]); `problem` the matching DeviceProblem.
    With `freeze`, a query whose probes are decided keeps its state (the
    batch runner). Returns the state."""
    if steps < 0:
        raise ValueError(f"steps = {steps}")
    queries = state.assign.shape[:-2]       # () for one query, (Q,) batched
    lead = queries[0] if queries else 1
    n_probes, v1 = state.assign.shape[-2:]
    if n_probes > 1024:
        raise ValueError(f"{n_probes} probes: the kernel takes at most 1024")
    if problem.valid.dim() != state.assign.dim():
        raise ValueError(f"valid: shape {tuple(problem.valid.shape)} does not "
                         f"match the state's queries")
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
    n_clauses = problem.valid.numel() // lead
    dev = state.assign.device
    key = torch.zeros((lead, n_probes, v1), dtype=torch.int32, device=dev)
    conflict = torch.zeros((lead, n_probes), dtype=torch.int32, device=dev)
    decided = torch.zeros(lead, dtype=torch.int32, device=dev) if freeze \
        else None
    for slot, value in ((Lay.K11_Q, lead), (Lay.K11_P, n_probes),
                        (Lay.K11_V1, v1), (Lay.K11_C, n_clauses),
                        (Lay.K11_FORCED_DEPTH, forced_depth),
                        (Lay.K11_STEPS, steps),
                        (Lay.K11_KEY, key.data_ptr()),
                        (Lay.K11_CONFLICT, conflict.data_ptr()),
                        (Lay.K11_DECIDED,
                         0 if decided is None else decided.data_ptr())):
        values[slot] = value
    _launch("mtpu_sat_run", values)
    LAUNCHES["sat_step"] += 1
    return state
