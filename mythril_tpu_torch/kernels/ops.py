"""Thin PyTorch wrappers around the hand-written CUDA kernels K1-K4.

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
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from . import build, layout as Lay

#: launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"keccak": 0, "evm_step": 0, "arena_alloc": 0,
                            "sym_step": 0}

#: which source each exported entry point lives in
_ENTRY_LIB = {"mtpu_keccak_rows": "keccak", "mtpu_sha_prep": "evm_step",
              "mtpu_evm_step": "evm_step", "mtpu_arena_alloc": "arena_alloc",
              "mtpu_sym_pre": "sym_step", "mtpu_sym_mid1": "sym_step",
              "mtpu_sym_mid2": "sym_step", "mtpu_sym_post": "sym_step"}
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
    class << 8)."""
    key = str(device)
    if key not in _OPTABS:
        from ..parallel import lockstep, symstep

        table = np.zeros((256, 4), dtype=np.int32)
        table[:, 0] = lockstep.POPS
        table[:, 1] = lockstep.PUSHES
        table[:, 2] = lockstep.GAS_MIN
        table[:, 3] = (lockstep.VALID * 1 | lockstep.ESCAPE_OPS * 2
                       | symstep.SYM_OK * 4 | symstep.PLUMBING * 8
                       | symstep.ENV_CLASS << 8)
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
    int32[B, 16]) for the lanes of `want`, in place. Returns (arena, ids,
    overflow)."""
    batch = want.shape[0]
    if batch > 1024:
        raise ValueError("arena_alloc scans in one block: at most 1024 lanes")
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
    for every lane, every tensor updated in place."""
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

    _launch("mtpu_sym_pre", values)
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
    _launch("mtpu_sym_post", values)
    LAUNCHES["sym_step"] += 1
    return state, planes, arena, sched
