"""Symbolic lockstep, core (port of mythril_tpu/parallel/symstep.py:86-1426).

Symbolic words live as int32 arena node ids in planes parallel to the
concrete StateBatch (SymPlanes). One `sym_step` for all lanes:

  1. frees ERRORED lanes and reseeds DEAD lanes from the scheduler's DFS
     sibling stack, deepest first;
  2. fetches each lane's opcode and classifies it: device-representable,
     FORK (symbolic JUMPI condition), cold-SLOAD pause, or ESCAPE;
  3. runs the concrete step (`lockstep.step`) with forced-out lanes frozen;
  4. allocates CONST, result and env-VAR arena nodes (`arena.alloc_*`);
  5. mirrors the effects onto the planes, buffers escaping rows, and forks
     symbolic JUMPIs: the sibling claims a DEAD lane, or is pushed to the
     stack, or spills to the escape buffer.

On CUDA tensors `sym_step` runs kernel K4 (`kernels/sym_step.cu`: plan,
move and per-lane launches over a grid of lane blocks, every rank a global
scan, K3's four allocations folded in) around kernel K2 (and K1 through
K2); it updates every tensor in place, at any lane count. `run_chunk`
replays a chunk of those steps as one CUDA graph (captured once per set of
tensors). On CPU tensors both run the plain twin, `sym_step_reference`,
which rebuilds the lane state and updates the scheduler pools and the
arena in place.

A sharded scheduler (`new_scheduler(..., n_shards=D)`, D > 1) splits the
lane axis into D equal contiguous blocks and both pools into D segments,
each with its own top (`stack_top`/`esc_count` are int32[D]): reseeds,
escape buffering, claims, pushes and spills rank segment-locally, so a
block's lanes only ever touch their own segment (symstep.py:315-330). With
D = 1 the step is the scalar one, bit for bit.

With `DeviceScheduler.telemetry` armed, the step also accumulates the
telemetry plane (op-class histogram, escape causes, lifecycle counters,
occupancy, high-water marks, tag and fleet occupancy); on the card that is
K4's `TEL` instantiation (kernel K9). `merge_pass` (state merging) runs
kernel K10 (`kernels/merge_pass.cu`, around K3) on CUDA tensors and
`merge_pass_reference` on CPU tensors."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from . import arena as A
from . import lockstep, words
from .batch import (DEAD, ERRORED, ESCAPED, FORKING, RUNNING, U32_FIELDS,
                    StateBatch)

I32 = torch.int32
I64 = torch.int64

O = lockstep.O

# ops whose result is representable as an arena node with symbolic operands
SYM_OK = np.zeros(256, dtype=bool)
for _name in ["ADD", "MUL", "SUB", "DIV", "SDIV", "MOD", "SMOD",
              "LT", "GT", "SLT", "SGT", "EQ", "ISZERO", "AND", "OR", "XOR",
              "NOT", "BYTE", "SHL", "SHR", "SAR"]:
    SYM_OK[O[_name]] = True

# ops that never need symbolic handling (stack shuffling and constants)
PLUMBING = np.zeros(256, dtype=bool)
PLUMBING[0x5F:0xA0] = True  # PUSH0-32, DUP1-16, SWAP1-16
for _name in ["POP", "JUMPDEST", "JUMP", "JUMPI", "PC", "MSIZE", "GAS",
              "STOP"]:
    PLUMBING[O[_name]] = True

#: env opcode byte -> arena var class (symbolic-env lanes)
ENV_CLASS = np.zeros(256, dtype=np.int32)
for _name, _cls in [("CALLER", A.V_CALLER), ("ORIGIN", A.V_ORIGIN),
                    ("CALLVALUE", A.V_CALLVALUE), ("GASPRICE", A.V_GASPRICE),
                    ("TIMESTAMP", A.V_TIMESTAMP), ("NUMBER", A.V_NUMBER),
                    ("COINBASE", A.V_COINBASE),
                    ("PREVRANDAO", A.V_PREVRANDAO),
                    ("BASEFEE", A.V_BASEFEE),
                    ("CALLDATASIZE", A.V_CALLDATASIZE)]:
    ENV_CLASS[O[_name]] = _cls

# ---- telemetry plane (symstep.py:86-183) --------------------------------------------
# Device-resident counters accumulated inside the step and appended to the
# per-chunk summary. `DeviceScheduler.telemetry is None` selects the step
# without them: on the card a separate instantiation of K4 (`TEL = false`).

#: opcode byte -> execution-histogram class
OP_CLASS_NAMES = ("arith", "cmp", "keccak", "env", "block", "mem",
                  "storage", "jump", "push", "dup", "swap", "log", "call",
                  "halt", "other")
N_OP_CLASSES = len(OP_CLASS_NAMES)
OP_CLASS = np.full(256, OP_CLASS_NAMES.index("other"), dtype=np.int32)
OP_CLASS[0x01:0x0C] = OP_CLASS_NAMES.index("arith")
OP_CLASS[0x10:0x1E] = OP_CLASS_NAMES.index("cmp")
OP_CLASS[0x20] = OP_CLASS_NAMES.index("keccak")
OP_CLASS[0x30:0x40] = OP_CLASS_NAMES.index("env")
OP_CLASS[0x5A] = OP_CLASS_NAMES.index("env")        # GAS
OP_CLASS[0x40:0x4B] = OP_CLASS_NAMES.index("block")
for _byte in (0x50, 0x51, 0x52, 0x53, 0x59, 0x5E):  # POP, M*, MSIZE, MCOPY
    OP_CLASS[_byte] = OP_CLASS_NAMES.index("mem")
for _byte in (0x54, 0x55, 0x5C, 0x5D):              # SLOAD/SSTORE/TLOAD/TSTORE
    OP_CLASS[_byte] = OP_CLASS_NAMES.index("storage")
for _byte in (0x56, 0x57, 0x58, 0x5B):              # JUMP/JUMPI/PC/JUMPDEST
    OP_CLASS[_byte] = OP_CLASS_NAMES.index("jump")
OP_CLASS[0x5F:0x80] = OP_CLASS_NAMES.index("push")
OP_CLASS[0x80:0x90] = OP_CLASS_NAMES.index("dup")
OP_CLASS[0x90:0xA0] = OP_CLASS_NAMES.index("swap")
OP_CLASS[0xA0:0xA5] = OP_CLASS_NAMES.index("log")
OP_CLASS[0xF0:0xFB] = OP_CLASS_NAMES.index("call")
for _byte in (0x00, 0xF3, 0xFD, 0xFE, 0xFF):  # STOP/RETURN/REVERT/INVALID/SD
    OP_CLASS[_byte] = OP_CLASS_NAMES.index("halt")

#: lane lifecycle transition counters
LIFECYCLE_NAMES = ("reseeds", "err_deaths", "overflow_kills",
                   "bad_jump_deaths", "esc_buffered", "esc_frozen",
                   "fork_waits", "cold_sloads", "forks_claimed",
                   "forks_pushed", "forks_spilled", "frozen_revived")
N_LIFECYCLE = len(LIFECYCLE_NAMES)

#: why lanes escaped to the host, priority-ordered most-specific-last
ESC_CAUSE_NAMES = ("halt", "sym_jump_dest", "detector_branch",
                   "sym_mem_off", "dirty_mload", "sym_storage_key",
                   "sym_mem_region", "host_op")
N_ESC_CAUSES = len(ESC_CAUSE_NAMES)

#: summary words contributed before the variable-length tag_occ block
TELEMETRY_FIXED_WORDS = N_OP_CLASSES + N_LIFECYCLE + N_ESC_CAUSES + 2 + 2

#: tag and fleet slots the kernel's shared-memory counters hold
MAX_TEL_SLOTS = 64

_TABLES = {}


def _tables(device) -> dict:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = {
            "sym_ok": torch.from_numpy(SYM_OK).to(device),
            "plumbing": torch.from_numpy(PLUMBING).to(device),
            "env_class": torch.from_numpy(ENV_CLASS.astype(np.int64))
            .to(device),
            "op_class": torch.from_numpy(OP_CLASS.astype(np.int64))
            .to(device),
        }
    return _TABLES[key]


class Telemetry(NamedTuple):
    """Device-resident frontier counters (cumulative across chunks)."""

    op_hist: torch.Tensor      # int64[N_OP_CLASSES] executed per class
    lifecycle: torch.Tensor    # int64[N_LIFECYCLE]
    esc_cause: torch.Tensor    # int64[N_ESC_CAUSES]
    occupancy: torch.Tensor    # int64[2] (running-lane-step sum, steps)
    hwm: torch.Tensor          # int64[2] (stack_top, esc_count high water)
    tag_pcs: torch.Tensor      # int32[K] static merge/loop-header pcs
    tag_occ: torch.Tensor      # int64[K] running-lane-steps at each tag
    fleet_slots: torch.Tensor  # int32[C] seeding context -> fleet slot
    fleet_occ: torch.Tensor    # int64[F] running-lane-steps per slot


def new_telemetry(tag_pcs=None, fleet_slots=None, n_fleet: int = 0,
                  device=None) -> Telemetry:
    """Zeroed counter plane (symstep.py:152). `tag_pcs` are byte addresses
    to count lane occupancy at; `fleet_slots` maps each seeding-context
    index to one of `n_fleet` slots (empty: no fleet block)."""
    dev = _device.resolve(device)
    pcs = np.asarray([] if tag_pcs is None else list(tag_pcs), dtype=np.int32)
    slots = np.asarray([] if fleet_slots is None else list(fleet_slots),
                       dtype=np.int32)

    def zeros(n):
        return torch.zeros(int(n), dtype=I64, device=dev)

    return Telemetry(
        op_hist=zeros(N_OP_CLASSES), lifecycle=zeros(N_LIFECYCLE),
        esc_cause=zeros(N_ESC_CAUSES), occupancy=zeros(2), hwm=zeros(2),
        tag_pcs=torch.from_numpy(pcs).to(dev), tag_occ=zeros(pcs.shape[0]),
        fleet_slots=torch.from_numpy(slots).to(dev),
        fleet_occ=zeros(n_fleet))


def telemetry_words(tel: Telemetry) -> torch.Tensor:
    """The counters as the int64 vector appended to the summary (layout:
    op_hist | lifecycle | esc_cause | occupancy | hwm | tag_occ |
    fleet_occ; symstep.py:176)."""
    return torch.cat([tel.op_hist, tel.lifecycle, tel.esc_cause,
                      tel.occupancy, tel.hwm, tel.tag_occ, tel.fleet_occ])


class SymPlanes(NamedTuple):
    """Symbolic shadow of the concrete StateBatch (0 = concrete)."""

    stack_sym: torch.Tensor      # int32[B, S] arena node per stack slot
    mem_sym: torch.Tensor        # int32[B, M] (node << 5 | byte_index)
    storage_sym: torch.Tensor    # int32[B, K] arena node per storage value
    storage_dirty: torch.Tensor  # bool[B, K] slot written
    storage_base_sym: torch.Tensor  # bool[B] storage base array is symbolic
    conds: torch.Tensor          # int32[B, KC] signed node ids
    cond_count: torch.Tensor     # int32[B]
    fork_cond: torch.Tensor      # int32[B] node pending at a FORKING lane
    symbolic_env: torch.Tensor   # bool[B]
    ctx_id: torch.Tensor         # int32[B] seeding-context index
    branches: torch.Tensor       # int32[B] JUMPI branches taken
    last_jump: torch.Tensor      # int32[B] byte address of the last JUMP

    @classmethod
    def empty(cls, batch: int, stack_slots: int, mem_bytes: int,
              storage_slots: int, max_conds: int = 64,
              device=None) -> "SymPlanes":
        dev = _device.resolve(device)

        def zeros(shape, dtype=I32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return cls(
            stack_sym=zeros((batch, stack_slots)),
            mem_sym=zeros((batch, mem_bytes)),
            storage_sym=zeros((batch, storage_slots)),
            storage_dirty=zeros((batch, storage_slots), torch.bool),
            storage_base_sym=zeros(batch, torch.bool),
            conds=zeros((batch, max_conds)),
            cond_count=zeros(batch),
            fork_cond=zeros(batch),
            symbolic_env=torch.ones(batch, dtype=torch.bool, device=dev),
            ctx_id=torch.full((batch,), -1, dtype=I32, device=dev),
            branches=zeros(batch),
            last_jump=zeros(batch),
        )


class DeviceScheduler(NamedTuple):
    """The frontier's worklist machine, resident on the device: a DFS
    sibling stack (`stack_*`), an escape buffer (`esc_*`) and counters."""

    stack_state: StateBatch    # [P] sibling rows
    stack_planes: SymPlanes
    stack_top: torch.Tensor    # int32[] rows used, or int32[D] per segment
    esc_state: StateBatch      # [E] escaped rows
    esc_planes: SymPlanes
    esc_count: torch.Tensor    # int32[] rows used, or int32[D] per segment
    executed: torch.Tensor     # int64[] instruction-states stepped
    forks: torch.Tensor        # int64[] fork events (claims + pushes + spills)
    pushes: torch.Tensor       # int64[] siblings pushed to the stack
    pops: torch.Tensor         # int64[] siblings reseeded from the stack
    enabled: torch.Tensor      # bool[] False = freeze/escape semantics
    telemetry: Optional[Telemetry] = None  # None = counters off
    # work stealing (sharded schedulers only, None with one shard)
    steals_sent: Optional[torch.Tensor] = None      # int64[D] rows donated
    steals_received: Optional[torch.Tensor] = None  # int64[D] rows adopted
    steal_rows: Optional[torch.Tensor] = None       # int64[] rows moved


def new_scheduler(state: StateBatch, planes: SymPlanes, stack_rows: int,
                  esc_rows: int, disabled: bool = False,
                  telemetry: Optional[Telemetry] = None,
                  n_shards: int = 1) -> DeviceScheduler:
    """Allocate scheduler pools shaped like (state, planes) rows on the
    state's device; `telemetry` arms the counter plane. With `n_shards`
    D > 1 the pools split into D equal segments (shard d owns rows
    [d*P/D, (d+1)*P/D)), the tops become int32[D] and the steal counters
    exist; both pool sizes must divide by D (symstep.py:261)."""
    if n_shards > 1 and (stack_rows % n_shards or esc_rows % n_shards):
        raise ValueError(f"pool rows ({stack_rows}, {esc_rows}) must divide "
                         f"n_shards={n_shards}")
    dev = state.stack.device
    sharded = n_shards > 1

    def rows(leaf, n):
        return torch.zeros((n,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                           device=dev)

    def scalar(value, dtype):
        return torch.tensor(value, dtype=dtype, device=dev)

    def top():
        return (torch.zeros(n_shards, dtype=I32, device=dev) if sharded
                else scalar(0, I32))

    def steals():
        return torch.zeros(n_shards, dtype=I64, device=dev) if sharded \
            else None

    return DeviceScheduler(
        stack_state=StateBatch(*[rows(leaf, stack_rows) for leaf in state]),
        stack_planes=SymPlanes(*[rows(leaf, stack_rows) for leaf in planes]),
        stack_top=top(),
        esc_state=StateBatch(*[rows(leaf, esc_rows) for leaf in state]),
        esc_planes=SymPlanes(*[rows(leaf, esc_rows) for leaf in planes]),
        esc_count=top(),
        executed=scalar(0, I64),
        forks=scalar(0, I64),
        pushes=scalar(0, I64),
        pops=scalar(0, I64),
        enabled=scalar(not disabled, torch.bool),
        telemetry=telemetry,
        steals_sent=steals(),
        steals_received=steals(),
        steal_rows=scalar(0, I64) if sharded else None,
    )


def n_segments(sched: DeviceScheduler) -> int:
    """D of a scheduler: 1 for scalar tops, else the tops' length."""
    return 1 if sched.stack_top.dim() == 0 else int(sched.stack_top.shape[0])


def _check_scheduler(sched: DeviceScheduler) -> None:
    tel = sched.telemetry
    if tel is not None and max(tel.tag_pcs.shape[0],
                               tel.fleet_occ.shape[0]) > MAX_TEL_SLOTS:
        raise ValueError(f"telemetry: more than {MAX_TEL_SLOTS} tag or "
                         "fleet slots")


def _where_rows(mask, rows, leaf):
    return torch.where(mask.reshape(mask.shape + (1,) * (leaf.dim() - 1)),
                       rows, leaf)


def _rank(mask: torch.Tensor) -> torch.Tensor:
    """0-based rank of each True lane among the True lanes."""
    return torch.cumsum(mask.to(I64), 0) - 1


def _seg_rank(mask: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Segment-local 0-based rank of each True lane: the lane axis is n_seg
    equal contiguous blocks and ranks restart at each (symstep.py:315);
    n_seg = 1 is the global rank."""
    return torch.cumsum(mask.to(I64).reshape(n_seg, -1), 1).reshape(-1) - 1


def _seg_sum(mask: torch.Tensor, n_seg: int) -> torch.Tensor:
    """int64[n_seg]: True lanes per contiguous lane block (symstep.py:323)."""
    return mask.to(I64).reshape(n_seg, -1).sum(1)


def _per_lane(vec: torch.Tensor, batch: int) -> torch.Tensor:
    """A per-segment value broadcast to every lane of its block
    (symstep.py:328)."""
    return torch.repeat_interleave(vec, batch // vec.shape[0])


def _put_rows(pool_leaf: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
              rows: torch.Tensor) -> None:
    """pool_leaf[dst[i]] = rows[i] where mask, in place (distinct dsts)."""
    idx = torch.nonzero(mask).flatten()
    if idx.numel():
        pool_leaf[dst[idx]] = rows[idx]


def _scatter_lanes(leaf: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    out = leaf.clone()
    _put_rows(out, dst, mask, rows)
    return out


def _operand_syms(state: StateBatch, planes: SymPlanes, n: int):
    """Arena node of the n-th-from-top stack slot (0 where concrete)."""
    slots = planes.stack_sym.shape[1]
    idx = (state.sp.to(I64) - n).clamp(0, slots - 1)
    return torch.gather(planes.stack_sym, 1, idx[:, None])[:, 0].to(I64)


def _range_has_sym(mem_sym, off, size):
    """bool[B]: any symbolic byte in [off, off+size) of mem_sym."""
    j = torch.arange(mem_sym.shape[1], device=mem_sym.device)
    in_range = (j[None, :] >= off[:, None]) & (j[None, :] < (off + size)[:, None])
    return torch.any(in_range & (mem_sym != 0), dim=1)


def sym_step_reference(state: StateBatch, planes: SymPlanes, arena: A.Arena,
                       sched: DeviceScheduler
                       ) -> Tuple[StateBatch, SymPlanes, A.Arena,
                                  DeviceScheduler]:
    """Plain PyTorch twin of one `sym_step` (symstep.py:347-910)."""
    _check_scheduler(sched)
    dev = state.stack.device
    ltab = lockstep.tables(dev)
    stab = _tables(dev)
    batch, slots = planes.stack_sym.shape
    mem_cap = planes.mem_sym.shape[1]
    lane = torch.arange(batch, device=dev)
    enabled = sched.enabled

    # counted before ERRORED lanes are freed (symstep.py:359)
    n_err_freed = (state.status == ERRORED).sum()
    state = state._replace(status=torch.where(
        state.status == ERRORED, DEAD, state.status).to(I32))

    # ---- reseed DEAD lanes from the sibling stack (deepest first) -------------------
    # segment-local when sharded: block d's DEAD lanes take from the top of
    # pool segment d (symstep.py:364-391); one segment is the scalar math
    pool_rows = sched.stack_state.status.shape[0]
    sharded = sched.stack_top.dim() == 1
    top_vec = sched.stack_top.reshape(-1).to(I64)
    n_seg = top_vec.shape[0]
    seg_pool = pool_rows // n_seg
    seg_ids = torch.arange(n_seg, dtype=I64, device=dev)
    top_l = _per_lane(top_vec, batch)
    base_l = _per_lane(seg_ids * seg_pool, batch)
    dead0 = state.status == DEAD
    rrank = _seg_rank(dead0, n_seg)
    take = dead0 & (rrank < top_l) & enabled
    src = (base_l + top_l - 1 - rrank).clamp(0, max(pool_rows - 1, 0))
    if bool(take.any()):
        state = StateBatch(*[_where_rows(take, pool[src], leaf)
                             for leaf, pool in zip(state, sched.stack_state)])
        planes = SymPlanes(*[_where_rows(take, pool[src], leaf)
                             for leaf, pool in zip(planes,
                                                   sched.stack_planes)])
    n_taken_vec = _seg_sum(take, n_seg)
    n_taken = n_taken_vec.sum()
    running = state.status == RUNNING

    def tops(vec):
        return vec.to(I32) if sharded else vec[0].to(I32)

    sched = sched._replace(stack_top=tops(top_vec - n_taken_vec),
                           pops=sched.pops + n_taken,
                           executed=sched.executed + running.sum())

    # ---- fetch + operand planes -----------------------------------------------------
    in_code = state.pc < state.code_len
    op = torch.where(in_code, torch.gather(
        state.code, 1, state.pc.to(I64)[:, None].clamp(
            0, state.code.shape[1] - 1))[:, 0].to(I64), O["STOP"])

    def is_op(name):
        return op == O[name]

    sym1 = _operand_syms(state, planes, 1)
    sym2 = _operand_syms(state, planes, 2)
    sym3 = _operand_syms(state, planes, 3)
    pops = ltab["pops"][op]
    any_operand_sym = (((pops >= 1) & (sym1 != 0)) | ((pops >= 2) & (sym2 != 0))
                       | ((pops >= 3) & (sym3 != 0)))

    a_limbs = lockstep.peek(state, 1)
    b_limbs = lockstep.peek(state, 2)
    off_i, off_fits = lockstep.word_to_i64(a_limbs)

    symbolic_env = planes.symbolic_env
    env_class = stab["env_class"][op]
    env_var_op = running & symbolic_env & (env_class != 0)
    cdl_op = running & symbolic_env & is_op("CALLDATALOAD")
    cdl_sym_off = cdl_op & (sym1 != 0)
    cdl_var = cdl_op & (sym1 == 0) & off_fits & (off_i < (1 << 30))

    # memory round trips
    mstore_sym_val = running & is_op("MSTORE") & (sym1 == 0) & (sym2 != 0)
    mload_mask = running & is_op("MLOAD") & (sym1 == 0)
    j32 = torch.arange(32, device=dev)
    mload_cells = torch.gather(
        planes.mem_sym, 1, (off_i[:, None] + j32).clamp(0, mem_cap - 1)
    ).to(I64)
    mload_first = torch.gather(planes.mem_sym, 1,
                               off_i.clamp(0, mem_cap - 1)[:, None])[:, 0] \
        .to(I64)
    mload_any_sym = torch.any(mload_cells != 0, dim=1)
    expected = torch.where((mload_first != 0)[:, None],
                           ((mload_first >> 5) << 5)[:, None] + j32, 0)
    mload_clean = mload_any_sym & (mload_first != 0) \
        & ((mload_first & 31) == 0) & torch.all(mload_cells == expected, dim=1)
    mload_node = torch.where(mload_clean, mload_first >> 5, 0)
    mload_dirty = mload_mask & mload_any_sym & ~mload_clean

    # storage
    sload_mask = running & is_op("SLOAD")
    sstore_mask = running & is_op("SSTORE")
    storage_match = lockstep._table_match(state.storage_keys,
                                          state.storage_used, a_limbs)
    storage_found = torch.any(storage_match, dim=-1)
    storage_slot = lockstep.first_true(storage_match)
    sload_node = torch.where(sload_mask & storage_found,
                             planes.storage_sym[lane, storage_slot].to(I64), 0)

    # ---- classify: FORK / PAUSE -----------------------------------------------------
    jumpi_sym_cond = running & is_op("JUMPI") & (sym2 != 0) & (sym1 == 0)
    cond_cls = arena.cls[sym2.clamp(0, arena.capacity - 1)].to(I64)
    cond_room = planes.cond_count + 1 <= planes.conds.shape[1]
    predictable = (cond_cls & A.PREDICTABLE_MASK) != 0
    jumpi_host = jumpi_sym_cond & (predictable | ~cond_room)
    jumpi_fork = jumpi_sym_cond & ~jumpi_host
    frozen_fork = (state.status == FORKING) & is_op("JUMPI") \
        & (sym2 != 0) & (sym1 == 0) & cond_room & ~predictable
    sload_cold = sload_mask & (sym1 == 0) & planes.storage_base_sym \
        & ~storage_found
    force_fork = jumpi_fork | sload_cold

    # ---- classify: ESCAPE -----------------------------------------------------------
    sym_representable = stab["sym_ok"][op] | stab["plumbing"][op]
    esc_always = running & (is_op("STOP") | is_op("RETURN") | is_op("REVERT")
                            | is_op("INVALID"))
    esc = any_operand_sym & ~sym_representable & ~mstore_sym_val \
        & ~(sload_mask | sstore_mask)
    esc = esc | (running & is_op("JUMP") & (sym1 != 0))
    esc = esc | (running & is_op("JUMPI") & (sym1 != 0))
    esc = esc | jumpi_host
    esc = esc | (running & is_op("MSTORE") & (sym1 != 0))
    esc = esc | (running & is_op("MLOAD") & (sym1 != 0))
    esc = esc | cdl_sym_off
    esc = esc | mload_dirty
    esc = esc | ((sload_mask | sstore_mask) & (sym1 != 0))
    reads_mem = is_op("SHA3") | is_op("RETURN") | is_op("REVERT")
    size_for_read = torch.where(reads_mem, lockstep.word_to_i64(b_limbs)[0], 0)
    copy_size_i = lockstep.word_to_i64(lockstep.peek(state, 3))[0]
    # reads or copies over symbolic memory bytes
    mem_region = (running & reads_mem & (sym1 == 0) & (sym2 == 0)
                  & _range_has_sym(planes.mem_sym, off_i,
                                   size_for_read.clamp(0, mem_cap))) \
        | (running & (is_op("CODECOPY") | is_op("RETURNDATACOPY"))
           & _range_has_sym(planes.mem_sym, off_i,
                            copy_size_i.clamp(0, mem_cap))) \
        | (running & is_op("MCOPY") & torch.any(planes.mem_sym != 0, dim=1))
    esc = esc | mem_region
    esc = esc | (running & symbolic_env & is_op("CALLDATACOPY"))
    esc = esc | (running & symbolic_env & is_op("SELFBALANCE"))
    force_escape = (esc | esc_always) & ~force_fork

    # ---- concrete semantics (forced-out lanes untouched) ----------------------------
    new_state = lockstep.step_reference(state, force_escape, force_fork)

    # ---- allocate nodes -------------------------------------------------------------
    advanced = running & ~force_escape & ~force_fork \
        & (new_state.status == RUNNING)
    sym_compute = advanced & any_operand_sym & stab["sym_ok"][op]
    need_const_a = sym_compute & (sym1 == 0) & (pops >= 1)
    arena, const_a, ovf_a = A.alloc_consts_reference(arena, need_const_a,
                                                     a_limbs)
    need_const_b = sym_compute & (sym2 == 0) & (pops >= 2)
    arena, const_b, ovf_b = A.alloc_consts_reference(arena, need_const_b,
                                                     b_limbs)
    node_a = torch.where(sym1 != 0, sym1, const_a.to(I64))
    node_b = torch.where(sym2 != 0, sym2, const_b.to(I64))
    zeros = torch.zeros_like(node_a)
    arena, result_node, ovf_r = A.alloc_rows_reference(
        arena, sym_compute, op, node_a, node_b, zeros, zeros, state.pc)

    env_alloc = advanced & (env_var_op | cdl_var)
    var_class = torch.where(cdl_var, A.V_CALLDATA_WORD, env_class)
    var_qual = torch.where(cdl_var, off_i, 0)
    arena, env_node, ovf_e = A.alloc_rows_reference(
        arena, env_alloc, torch.full_like(op, A.VAR), zeros, zeros, zeros,
        var_class, var_qual)

    overflow = ovf_a | ovf_b | ovf_r | ovf_e
    new_state = new_state._replace(
        status=torch.where(overflow, DEAD, new_state.status).to(I32))

    # ---- mirror plane effects -------------------------------------------------------
    new_top_node = torch.where(
        sym_compute, result_node.to(I64),
        torch.where(env_alloc, env_node.to(I64),
                    torch.where(mload_mask & mload_clean, mload_node,
                                sload_node)))
    new_planes = sym_stack_update(state, new_state, planes, op, advanced,
                                  new_top_node)

    mem_sym = new_planes.mem_sym.clone()
    cells = (off_i[:, None] + j32).clamp(0, mem_cap - 1)
    mstore_adv = advanced & mstore_sym_val
    rows = torch.nonzero(mstore_adv).flatten()
    mem_sym[rows[:, None], cells[rows]] = \
        ((sym2[rows, None] << 5) + j32).to(I32)
    mstore_concrete = advanced & is_op("MSTORE") & (sym1 == 0) & (sym2 == 0)
    rows = torch.nonzero(mstore_concrete).flatten()
    mem_sym[rows[:, None], cells[rows]] = 0
    mstore8_concrete = advanced & is_op("MSTORE8") & (sym1 == 0) & (sym2 == 0)
    rows = torch.nonzero(mstore8_concrete).flatten()
    mem_sym[rows, cells[rows, 0]] = 0

    new_match = lockstep._table_match(new_state.storage_keys,
                                      new_state.storage_used, a_limbs)
    new_slot = lockstep.first_true(new_match)
    sstore_any = advanced & sstore_mask & (sym1 == 0) \
        & torch.any(new_match, dim=-1)
    rows = torch.nonzero(sstore_any).flatten()
    storage_sym = new_planes.storage_sym.clone()
    storage_sym[rows, new_slot[rows]] = sym2[rows].to(I32)
    storage_dirty = new_planes.storage_dirty.clone()
    storage_dirty[rows, new_slot[rows]] = True

    was_running = state.status == RUNNING
    fork_cond = torch.where(was_running & jumpi_fork, sym2,
                            torch.where(was_running & sload_cold, 0,
                                        new_planes.fork_cond.to(I64)))
    new_planes = new_planes._replace(
        mem_sym=mem_sym, storage_sym=storage_sym,
        storage_dirty=storage_dirty, fork_cond=fork_cond.to(I32),
        branches=torch.where(advanced & is_op("JUMPI"),
                             new_planes.branches + 1,
                             new_planes.branches).to(I32),
        last_jump=torch.where(advanced & is_op("JUMP"), state.pc,
                              new_planes.last_jump).to(I32))

    # ---- escape buffering (before forking: freed lanes are claimable) ---------------
    esc_rows = sched.esc_state.status.shape[0]
    ecount_vec = sched.esc_count.reshape(-1).to(I64)
    seg_esc = esc_rows // n_seg
    ecount_l = _per_lane(ecount_vec, batch)
    ebase_l = _per_lane(seg_ids * seg_esc, batch)
    esc_now = (new_state.status == ESCAPED) & enabled
    erank = _seg_rank(esc_now, n_seg)
    put = esc_now & (erank < seg_esc - ecount_l)
    eslot = ebase_l + ecount_l + erank
    for pool, leaf in zip(list(sched.esc_state) + list(sched.esc_planes),
                          list(new_state) + list(new_planes)):
        _put_rows(pool, eslot, put, leaf)
    esc_used_vec = ecount_vec + _seg_sum(put, n_seg)
    new_state = new_state._replace(
        status=torch.where(put, DEAD, new_state.status).to(I32))

    # ---- on-device JUMPI forking ----------------------------------------------------
    # claims, pushes and spills stay in the forker's own block and segments
    max_conds = planes.conds.shape[1]
    want = jumpi_fork | frozen_fork
    lane_base_l = _per_lane(seg_ids * (batch // n_seg), batch)
    is_dead = new_state.status == DEAD
    dead_map = torch.zeros(batch + 1, dtype=I64, device=dev)
    dead_map[torch.where(is_dead, lane_base_l + _seg_rank(is_dead, n_seg),
                         batch)] = lane
    fork_rank = _seg_rank(want, n_seg)
    have_target = want & (fork_rank < _per_lane(_seg_sum(is_dead, n_seg),
                                                 batch))
    target = dead_map[(lane_base_l + fork_rank).clamp(0, batch - 1)]
    top2_vec = sched.stack_top.reshape(-1).to(I64)
    top2_l = _per_lane(top2_vec, batch)
    push_want = want & ~have_target & enabled
    push_rank = _seg_rank(push_want, n_seg)
    push = push_want & (push_rank < seg_pool - top2_l)
    eused_l = _per_lane(esc_used_vec, batch)
    spill_want = push_want & ~push
    spill_rank = _seg_rank(spill_want, n_seg)
    spill = spill_want & (spill_rank < seg_esc - eused_l)
    act = have_target | push | spill

    code_cap = state.code.shape[1]
    dest_ok = off_fits & (off_i >= 0) & (off_i < state.code_len.to(I64)) \
        & torch.gather(state.jumpdest, 1,
                       off_i.clamp(0, code_cap - 1)[:, None])[:, 0]
    count = planes.cond_count.to(I64).clamp(0, max_conds - 1)

    # 1. the forker row as the shared post-fork template
    sp_fork = torch.where(act, state.sp - 2, new_state.sp).to(I32)
    gas_fork = torch.where(act, state.gas_used + ltab["gas_min"][op],
                           new_state.gas_used)
    rows = torch.nonzero(act).flatten()
    conds_fork = new_planes.conds.clone()
    conds_fork[rows, count[rows]] = sym2[rows].to(I32)
    ccount_fork = torch.where(act, planes.cond_count + 1,
                              new_planes.cond_count).to(I32)
    branches_fork = torch.where(act, planes.branches + 1,
                                new_planes.branches).to(I32)
    cleared = act[:, None] & (torch.arange(slots, device=dev)[None, :]
                              >= sp_fork[:, None])
    ssym_fork = torch.where(cleared, 0, new_planes.stack_sym)
    state_a = new_state._replace(sp=sp_fork, gas_used=gas_fork)
    planes_a = new_planes._replace(conds=conds_fork, cond_count=ccount_fork,
                                   stack_sym=ssym_fork,
                                   branches=branches_fork)

    # 2. the fall-through sibling rows
    sib_conds = conds_fork.clone()
    sib_conds[rows, count[rows]] = (-sym2[rows]).to(I32)
    sib_state = state_a._replace(
        pc=torch.where(act, state.pc + 1, state_a.pc).to(I32),
        status=torch.where(act, RUNNING, state_a.status).to(I32))
    sib_planes = planes_a._replace(
        conds=sib_conds,
        fork_cond=torch.where(act, 0, planes_a.fork_cond).to(I32))

    # 3a. claim: sibling rows into the claimed DEAD lanes
    state_b = StateBatch(*[_scatter_lanes(leaf, target, have_target, sib)
                           for leaf, sib in zip(state_a, sib_state)])
    planes_b = SymPlanes(*[_scatter_lanes(leaf, target, have_target, sib)
                           for leaf, sib in zip(planes_a, sib_planes)])
    # 3b. push onto the stack; 3c. spill into the escape buffer
    sib_leaves = list(sib_state) + list(sib_planes)
    for pool, sib in zip(list(sched.stack_state) + list(sched.stack_planes),
                         sib_leaves):
        _put_rows(pool, base_l + top2_l + push_rank, push, sib)
    for pool, sib in zip(list(sched.esc_state) + list(sched.esc_planes),
                         sib_leaves):
        _put_rows(pool, ebase_l + eused_l + spill_rank, spill, sib)
    sched = sched._replace(
        stack_top=tops(top2_vec + _seg_sum(push, n_seg)),
        esc_count=tops(esc_used_vec + _seg_sum(spill, n_seg)),
        pushes=sched.pushes + push.sum(),
        forks=sched.forks + act.sum())

    # 4. forker divergence: take the jump (or die on an invalid dest)
    new_state = state_b._replace(
        pc=torch.where(act, off_i.to(I32), state_b.pc),
        status=torch.where(act, torch.where(dest_ok, RUNNING, DEAD).to(I32),
                           state_b.status))
    new_planes = planes_b._replace(
        fork_cond=torch.where(act, 0, planes_b.fork_cond).to(I32))

    # ---- telemetry (symstep.py:822-908) --------------------------------------------
    tel = sched.telemetry
    if tel is not None:
        # the most specific matching cause wins (the where-chain's order)
        cause = torch.full((batch,), N_ESC_CAUSES, dtype=I64, device=dev)
        for mask, name in (
                (force_escape, "host_op"),
                (mem_region, "sym_mem_region"),
                ((sload_mask | sstore_mask) & (sym1 != 0), "sym_storage_key"),
                (mload_dirty, "dirty_mload"),
                ((running & (is_op("MSTORE") | is_op("MLOAD")) & (sym1 != 0))
                 | cdl_sym_off, "sym_mem_off"),
                (jumpi_host, "detector_branch"),
                (running & (is_op("JUMP") | is_op("JUMPI")) & (sym1 != 0),
                 "sym_jump_dest"),
                (esc_always, "halt")):
            cause = torch.where(mask, ESC_CAUSE_NAMES.index(name), cause)

        def hist(values, n):
            values = values[(values >= 0) & (values < n)]
            return torch.bincount(values, minlength=n)[:n]

        lc_deltas = torch.stack([
            n_taken, n_err_freed, overflow.sum(), (act & ~dest_ok).sum(),
            put.sum(), (esc_now & ~put).sum(), (want & ~act).sum(),
            sload_cold.sum(), have_target.sum(), push.sum(), spill.sum(),
            (frozen_fork & act).sum()]).to(I64)
        tag_occ = tel.tag_occ + (running[:, None] & (
            state.pc[:, None] == tel.tag_pcs[None, :])).sum(0)
        fleet_occ = tel.fleet_occ
        if fleet_occ.shape[0]:
            n_ctx = tel.fleet_slots.shape[0]
            slot = tel.fleet_slots[planes.ctx_id.to(I64).clamp(0, n_ctx - 1)]
            fleet_occ = fleet_occ + hist(slot[running].to(I64),
                                         fleet_occ.shape[0])
        sched = sched._replace(telemetry=tel._replace(
            op_hist=tel.op_hist + hist(stab["op_class"][op[running]],
                                       N_OP_CLASSES),
            lifecycle=tel.lifecycle + lc_deltas,
            esc_cause=tel.esc_cause + hist(cause[force_escape], N_ESC_CAUSES),
            occupancy=tel.occupancy + torch.stack(
                [running.sum(), torch.ones((), dtype=I64, device=dev)]),
            # vector tops report the global rows in use (symstep.py:878)
            hwm=torch.maximum(tel.hwm, torch.stack(
                [sched.stack_top.to(I64).sum(),
                 sched.esc_count.to(I64).sum()])),
            tag_occ=tag_occ, fleet_occ=fleet_occ))
    return new_state, new_planes, arena, sched


def sym_stack_update(state: StateBatch, new_state: StateBatch,
                     planes: SymPlanes, op, advanced, new_top_node
                     ) -> SymPlanes:
    """Mirror the concrete stack effect onto the node plane (plain twin of
    `_sym_stack_update`, symstep.py:913): write the produced node (or 0) at
    the new top, clear slots above the new sp, DUP copies the source slot's
    node, SWAP exchanges two nodes."""
    batch, slots = planes.stack_sym.shape
    dev = op.device
    lane = torch.arange(batch, device=dev)
    stack_sym = planes.stack_sym.clone()
    sp = state.sp.to(I64)

    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)
    writes_result = (lockstep.tables(dev)["pushes"][op] >= 1) & ~is_swap
    dup_src = (sp - (op - 0x7F).clamp(1, 16)).clamp(0, slots - 1)
    top_value = torch.where(is_dup, stack_sym[lane, dup_src].to(I64),
                            new_top_node)
    write_idx = (new_state.sp.to(I64) - 1).clamp(0, slots - 1)
    rows = torch.nonzero(advanced & writes_result).flatten()
    stack_sym[rows, write_idx[rows]] = top_value[rows].to(I32)

    above = advanced[:, None] & (torch.arange(slots, device=dev)[None, :]
                                 >= new_state.sp[:, None])
    stack_sym = torch.where(above, 0, stack_sym)

    swap_n = (op - 0x8F).clamp(1, 16)
    top_idx = (sp - 1).clamp(0, slots - 1)
    deep_idx = (sp - 1 - swap_n).clamp(0, slots - 1)
    top_node = stack_sym[lane, top_idx]
    deep_node = stack_sym[lane, deep_idx]
    rows = torch.nonzero(advanced & is_swap).flatten()
    stack_sym[rows, top_idx[rows]] = deep_node[rows]
    stack_sym[rows, deep_idx[rows]] = top_node[rows]
    return planes._replace(stack_sym=stack_sym)


def sym_step(state: StateBatch, planes: SymPlanes, arena: A.Arena,
             sched: DeviceScheduler):
    """One symbolic step: kernel K4 (around K1-K3) on CUDA tensors, updating
    every tensor in place; the plain twin on CPU tensors."""
    _check_scheduler(sched)
    if state.stack.is_cuda:
        from ..kernels import ops

        return ops.sym_step(state, planes, arena, sched)
    return sym_step_reference(state, planes, arena, sched)


def run_chunk(state: StateBatch, planes: SymPlanes, arena: A.Arena,
              sched: DeviceScheduler, n_steps: int, graph: bool = True):
    """n_steps symbolic steps with the on-device scheduler engaged. On CUDA
    tensors the chunk is one CUDA graph, captured once for these tensors
    and replayed (`graph=False`: eager `sym_step` calls); in place."""
    if graph and n_steps > 0 and state.stack.is_cuda:
        _check_scheduler(sched)
        from ..kernels import ops

        return ops.run_chunk_graph(state, planes, arena, sched, n_steps)
    for _ in range(n_steps):
        state, planes, arena, sched = sym_step(state, planes, arena, sched)
    return state, planes, arena, sched


def run_chunk_reference(state: StateBatch, planes: SymPlanes, arena: A.Arena,
                        sched: DeviceScheduler, n_steps: int):
    """`run_chunk` through the plain twins, on any device."""
    for _ in range(n_steps):
        state, planes, arena, sched = sym_step_reference(state, planes,
                                                         arena, sched)
    return state, planes, arena, sched


def sym_step_many(state: StateBatch, planes: SymPlanes, arena: A.Arena,
                  n_steps: int):
    """Driver-less entry: scheduler disabled (one-row pools), so forkers
    freeze at saturation and escapes stay frozen ESCAPED."""
    sched = new_scheduler(state, planes, 1, 1, disabled=True)
    state, planes, arena, _ = run_chunk(state, planes, arena, sched, n_steps)
    return state, planes, arena


def sym_step_many_counted(state: StateBatch, planes: SymPlanes,
                          arena: A.Arena, n_steps: int):
    """Driver-less entry plus the executed-instruction count."""
    sched = new_scheduler(state, planes, 1, 1, disabled=True)
    state, planes, arena, sched = run_chunk(state, planes, arena, sched,
                                            n_steps)
    return state, planes, arena, sched.executed


# ---- on-device state merging (symstep.py:1004-1426) ---------------------------------
# Fork siblings reconverged at a join differ only in the sign of their last
# path condition and in what the two arms wrote. `merge_pass` pairs them by
# a content hash (sorted, then verified exactly), drops the last condition,
# ITE-blends every differing stack / storage slot (and, in the widened
# rounds, every differing 32-byte memory window the absint table allows)
# through arena op 0x0F and retires the partner DEAD.

#: frontier.merge.ite_depth buckets (blended slots per pair)
MERGE_DEPTH_LABELS = ("0", "1", "2", "3", "4-7", "8+")
N_MERGE_DEPTH = len(MERGE_DEPTH_LABELS)

#: blocked-by counters in the stats vector, in this order
MERGE_BLOCKED_LABELS = ("memory", "mem_sym", "storage_keys", "tstore",
                        "depth")

#: stats layout: [merges, ites, mem_blends, blocked_by[5], tag_hits[K],
#: depth_hist[6]]
MERGE_STATS_FIXED = 3 + len(MERGE_BLOCKED_LABELS)

_H_PRIME = 1099511628211
_H_MASK = (1 << 62) - 1
#: the sort key of every lane that cannot pair
_H_SENTINEL = 0x7FFFFFFFFFFFFFFF
#: arena op of an if-then-else node
ITE_OP = 0x0F

#: leaves a merge must find identical, as (tree, field): the weak set, the
#: memory planes the widened rounds relax, and the core set of the
#: blocked-by accounting
MERGE_WEAK_LEAVES = (
    ("state", "pc"), ("state", "sp"), ("state", "msize"),
    ("state", "code_len"), ("state", "retdata_len"), ("state", "retdata"),
    ("state", "storage_keys"), ("state", "storage_used"),
    ("state", "tstore_keys"), ("state", "tstore_vals"),
    ("state", "tstore_used"), ("planes", "storage_base_sym"),
    ("planes", "symbolic_env"), ("planes", "ctx_id"))
MERGE_MEM_LEAVES = (("state", "memory"), ("planes", "mem_sym"))
MERGE_CORE_LEAVES = (
    ("state", "pc"), ("state", "sp"), ("state", "msize"),
    ("state", "code_len"), ("state", "retdata_len"), ("state", "retdata"),
    ("planes", "symbolic_env"), ("planes", "ctx_id"))


def _leaf(state: StateBatch, planes: SymPlanes, tree: str, field: str):
    return getattr(state if tree == "state" else planes, field)


def _merge_fold(acc: torch.Tensor, leaf: torch.Tensor,
                unsigned: bool = False) -> torch.Tensor:
    """Fold one per-lane leaf into the lane hash (symstep.py:1042): int64
    wraparound, position-weighted. `unsigned`: the leaf's JAX dtype is
    uint32 (held as int32 here), so it widens with zeros, not the sign."""
    flat = leaf.reshape(leaf.shape[0], -1).to(I64)
    if unsigned:
        flat = flat & 0xFFFFFFFF
    mult = (torch.arange(flat.shape[1], dtype=I64, device=flat.device)
            * 2654435761 + 0x9E3779B9) | 1
    return acc * _H_PRIME + (flat * mult[None, :]).sum(1)


def _merge_hash(state, planes, leaves, acc=None) -> torch.Tensor:
    if acc is None:
        acc = torch.zeros(state.pc.shape[0], dtype=I64, device=state.pc.device)
    for tree, field in leaves:
        acc = _merge_fold(acc, _leaf(state, planes, tree, field),
                          tree == "state" and field in U32_FIELDS)
    return acc


def _rows_equal(leaf: torch.Tensor, ti, fi) -> torch.Tensor:
    a, b = leaf[ti], leaf[fi]
    return (a == b).reshape(a.shape[0], -1).all(1)


def _merge_keys(state, planes):
    """Per lane: (cond_count, index of the last condition, the last
    condition, conds with its sign stripped, eligible to pair)."""
    lane = torch.arange(state.pc.shape[0], device=state.pc.device)
    max_conds = planes.conds.shape[1]
    cc = planes.cond_count.to(I64)
    last_idx = (cc - 1).clamp(0, max_conds - 1)
    last = planes.conds[lane, last_idx].to(I64)
    conds_abs = planes.conds.clone()
    conds_abs[lane, last_idx] = last.abs().to(I32)
    eligible = (state.status == RUNNING) & (cc > 0) & (last != 0) \
        & (planes.fork_cond == 0)
    return cc, last_idx, last, conds_abs, eligible


def _pairs(key: torch.Tensor, shift: int):
    """(fi, ti): the stable sort of `key` rolled left by `shift`, cut into
    adjacent pairs."""
    half = key.shape[0] // 2
    perm = torch.roll(torch.argsort(key, stable=True), -shift)
    return perm[0:2 * half:2], perm[1:2 * half:2]


def _blend_family(arena, ok, live, sym_t, sym_f, conc_t, conc_f, cond):
    """Allocate one slot family's blends (symstep.py:1234-1289): CONST
    nodes for differing concrete slots, then an ITE row per differing slot.
    Returns (arena, diff, ite ids, overflow), all [pairs, slots]."""
    pairs, slots = sym_t.shape
    diff = ok[:, None] & live & ((sym_t != sym_f) | (
        (sym_t == 0) & (sym_f == 0) & (conc_t != conc_f).any(-1)))
    limbs = conc_t.shape[-1]
    arena, cid_t, ovf1 = A.alloc_consts_reference(
        arena, (diff & (sym_t == 0)).reshape(-1),
        conc_t.reshape(pairs * slots, limbs))
    arena, cid_f, ovf2 = A.alloc_consts_reference(
        arena, (diff & (sym_f == 0)).reshape(-1),
        conc_f.reshape(pairs * slots, limbs))
    node_t = torch.where(sym_t.reshape(-1) != 0, sym_t.reshape(-1), cid_t)
    node_f = torch.where(sym_f.reshape(-1) != 0, sym_f.reshape(-1), cid_f)
    zero = torch.zeros_like(node_t)
    arena, ite, ovf3 = A.alloc_rows_reference(
        arena, diff.reshape(-1), torch.full_like(node_t, ITE_OP),
        cond[:, None].expand(pairs, slots).reshape(-1), node_t, node_f,
        zero, zero)
    return (arena, diff, ite.reshape(pairs, slots),
            (ovf1 | ovf2 | ovf3).reshape(pairs, slots))


def _merge_round(state, planes, arena, stats, merge_pcs, mem_pcs, mem_words,
                 base_h, shift: int, widen: bool):
    """One pairing round of `merge_pass_reference`, in place."""
    dev = state.pc.device
    half = state.pc.shape[0] // 2
    mem_cap = planes.mem_sym.shape[1]
    n_tags = merge_pcs.shape[0]
    j32 = torch.arange(32, device=dev)
    cc, last_idx, last, conds_abs, eligible = _merge_keys(state, planes)
    if widen:
        at_join = state.pc[:, None] == mem_pcs[None, :]
        eligible = eligible & at_join.any(1)
        join_row = at_join.to(I32).argmax(1)
    h = _merge_fold(base_h, conds_abs) * _H_PRIME + cc
    key = torch.where(eligible, ((h & _H_MASK) << 1) | (last > 0).to(I64),
                      _H_SENTINEL)
    fi, ti = _pairs(key, shift)

    last_t = last[ti]
    ok = eligible[ti] & eligible[fi] & (last_t > 0) & (last_t == -last[fi]) \
        & (cc[ti] == cc[fi]) & (conds_abs[ti] == conds_abs[fi]).all(1)
    for tree, field in MERGE_WEAK_LEAVES + (() if widen else MERGE_MEM_LEAVES):
        ok &= _rows_equal(_leaf(state, planes, tree, field), ti, fi)

    if widen:
        # every differing memory byte or mark inside a valid window of the
        # join, and each differing window one well-defined word per side
        n_wins = mem_words.shape[1]
        wins = mem_words[join_row[ti].to(I64)]
        valid_w = (wins >= 0) & (wins + 32 <= mem_cap)
        idx = wins[:, :, None].to(I64) + j32
        safe = idx.clamp(0, mem_cap - 1).reshape(half, -1)

        def win_gather(plane, rows):
            return torch.gather(plane[rows], 1, safe).reshape(half, n_wins, 32)

        mem_tg, mem_fg = (win_gather(state.memory, ti),
                          win_gather(state.memory, fi))
        sym_tg, sym_fg = (win_gather(planes.mem_sym, ti),
                          win_gather(planes.mem_sym, fi))
        mdiff_all = (state.memory[ti] != state.memory[fi]) \
            | (planes.mem_sym[ti] != planes.mem_sym[fi])
        wdiff_cells = ((mem_tg != mem_fg) | (sym_tg != sym_fg)) \
            & valid_w[:, :, None]
        contained = mdiff_all.sum(1) == wdiff_cells.sum((1, 2))
        wdiff = wdiff_cells.any(2)

        def word_view(sym_g):
            first = sym_g[:, :, 0]
            clean = (first != 0) & ((first & 31) == 0) \
                & (sym_g == first[:, :, None] + j32).all(2)
            return (sym_g == 0).all(2), first, clean

        all0_t, first_t, clean_t = word_view(sym_tg)
        all0_f, first_f, clean_f = word_view(sym_fg)
        blendable = (all0_t | clean_t) & (all0_f | clean_f)
        ok &= contained & (~(wdiff & valid_w) | blendable).all(1)
        need = wdiff & valid_w & ok[:, None]
        flat = half * n_wins
        arena, mcid_t, movf1 = A.alloc_consts_reference(
            arena, (need & all0_t).reshape(-1),
            words.from_bytes(mem_tg).reshape(flat, -1))
        arena, mcid_f, movf2 = A.alloc_consts_reference(
            arena, (need & all0_f).reshape(-1),
            words.from_bytes(mem_fg).reshape(flat, -1))
        mnode_t = torch.where(all0_t.reshape(-1), mcid_t,
                              (first_t >> 5).reshape(-1))
        mnode_f = torch.where(all0_f.reshape(-1), mcid_f,
                              (first_f >> 5).reshape(-1))
        mzero = torch.zeros_like(mnode_t)
        arena, ite_m, movf3 = A.alloc_rows_reference(
            arena, need.reshape(-1), torch.full_like(mnode_t, ITE_OP),
            last_t[:, None].expand(half, n_wins).reshape(-1), mnode_t,
            mnode_f, mzero, mzero)
        mem_ovf = (movf1 | movf2 | movf3).reshape(half, n_wins)

    slots = planes.stack_sym.shape[1]
    live = torch.arange(slots, device=dev)[None, :] < state.sp[ti][:, None]
    sym_t, ksym_t = planes.stack_sym[ti], planes.storage_sym[ti]
    arena, sdiff, ite_s, stack_ovf = _blend_family(
        arena, ok, live, sym_t, planes.stack_sym[fi], state.stack[ti],
        state.stack[fi], last_t)
    arena, kdiff, ite_k, storage_ovf = _blend_family(
        arena, ok, state.storage_used[ti], ksym_t, planes.storage_sym[fi],
        state.storage_vals[ti], state.storage_vals[fi], last_t)
    # arena exhaustion mid-blend cancels the pair (its nodes stay allocated)
    merged = ok & ~stack_ovf.any(1) & ~storage_ovf.any(1)
    if widen:
        merged &= ~mem_ovf.any(1)

    # ---- apply: rewrite the survivor, retire the partner ----------------------------
    m2 = merged[:, None]
    rows_t, rows_f = ti[merged], fi[merged]
    updates = [
        (planes.stack_sym, torch.where(sdiff & m2, ite_s, sym_t)),
        (planes.storage_sym, torch.where(kdiff & m2, ite_k, ksym_t)),
        (planes.storage_dirty, planes.storage_dirty[ti]
         | planes.storage_dirty[fi]),
        (planes.cond_count, (cc[ti] - 1).to(I32)),
        (planes.branches, torch.maximum(planes.branches[ti],
                                        planes.branches[fi])),
        (state.gas_used, torch.maximum(state.gas_used[ti],
                                       state.gas_used[fi]))]
    for leaf, rows in updates:
        leaf[rows_t] = rows[merged]
    planes.conds[rows_t, last_idx[ti][merged]] = 0
    state.status[rows_f] = DEAD
    if widen:
        blend = (need & m2)[:, :, None].expand(idx.shape)
        cells = ((ite_m.reshape(half, n_wins)[:, :, None] << 5) + j32) \
            .to(I32)
        rows3 = ti[:, None, None].expand(idx.shape)
        planes.mem_sym[rows3[blend], idx[blend]] = cells[blend]

    # ---- stats ----------------------------------------------------------------------
    depth = (sdiff & m2).sum(1) + (kdiff & m2).sum(1)
    if widen:
        depth = depth + (need & m2).sum(1)
        stats[2] += (merged & need.any(1)).sum()
    stats[0] += merged.sum()
    stats[1] += depth.sum()
    if n_tags:
        stats[MERGE_STATS_FIXED:MERGE_STATS_FIXED + n_tags] += (
            m2 & (state.pc[ti][:, None] == merge_pcs[None, :])).sum(0)
    bucket = torch.where(depth >= 8, 5, torch.where(depth >= 4, 4, depth))
    stats.index_add_(0, MERGE_STATS_FIXED + n_tags + bucket[merged],
                     torch.ones_like(bucket[merged]))
    return arena


def _merge_blocked(state, planes, stats) -> None:
    """The blocked-by accounting (symstep.py:1374-1425): pair lanes whose
    core state matches and that did not merge; charge each pair to the
    first gate that refused it. Modifies only `stats`."""
    cc, _last_idx, last, conds_abs, eligible = _merge_keys(state, planes)
    core_h = _merge_hash(state, planes, MERGE_CORE_LEAVES)
    key = torch.where(eligible, ((core_h & _H_MASK) << 1)
                      | (last > 0).to(I64), _H_SENTINEL)
    fi, ti = _pairs(key, 0)

    def eq(tree, field):
        return _rows_equal(_leaf(state, planes, tree, field), ti, fi)

    cand = eligible[ti] & eligible[fi]
    for tree, field in MERGE_CORE_LEAVES:
        cand &= eq(tree, field)
    sib = (last[ti] > 0) & (last[ti] == -last[fi]) & (cc[ti] == cc[fi]) \
        & (conds_abs[ti] == conds_abs[fi]).all(1)
    blocked_depth = cand & ~sib
    rest = cand & sib
    keys_eq = eq("state", "storage_keys") & eq("state", "storage_used") \
        & eq("planes", "storage_base_sym")
    blocked_storage = rest & ~keys_eq
    rest &= keys_eq
    ts_eq = eq("state", "tstore_keys") & eq("state", "tstore_vals") \
        & eq("state", "tstore_used")
    blocked_tstore = rest & ~ts_eq
    rest &= ts_eq
    msym_eq, mem_eq = eq("planes", "mem_sym"), eq("state", "memory")
    for slot, blocked in ((3, rest & msym_eq & ~mem_eq), (4, rest & ~msym_eq),
                          (5, blocked_storage), (6, blocked_tstore),
                          (7, blocked_depth)):
        stats[slot] += blocked.sum()


def _merge_tables(merge_pcs, mem_pcs, mem_words, device):
    """The three static tables as int32 tensors on `device` (no window
    table: zero rows)."""
    def table(values, empty_shape):
        if values is None:
            values = np.zeros(empty_shape, dtype=np.int32)
        if isinstance(values, torch.Tensor):
            return values.to(device=device, dtype=I32).contiguous()
        return torch.as_tensor(np.asarray(values, dtype=np.int32),
                               device=device)

    if mem_pcs is None:
        mem_words = None
    return (table(merge_pcs, 0), table(mem_pcs, 0),
            table(mem_words, (0, 1)))


def merge_pass_reference(state: StateBatch, planes: SymPlanes,
                         arena: A.Arena, merge_pcs, mem_pcs=None,
                         mem_words=None, n_rounds: int = 6):
    """Plain twin of `merge_pass` (symstep.py:1057): `n_rounds` strict
    pairing rounds, then (with a window table: `mem_pcs` int32[J],
    `mem_words` int32[J, W], -1 padded) `n_rounds` widened rounds, then
    the blocked-by accounting. Updates state, planes and arena in place;
    returns (state, planes, arena, stats int64[MERGE_STATS_FIXED + K +
    N_MERGE_DEPTH])."""
    merge_pcs, mem_pcs, mem_words = _merge_tables(merge_pcs, mem_pcs,
                                                  mem_words, state.pc.device)
    weak_h = _merge_hash(state, planes, MERGE_WEAK_LEAVES)
    static_h = _merge_hash(state, planes, MERGE_MEM_LEAVES, weak_h)
    stats = torch.zeros(MERGE_STATS_FIXED + merge_pcs.shape[0]
                        + N_MERGE_DEPTH, dtype=I64, device=state.pc.device)
    phases = [(static_h, False)]
    if mem_pcs.shape[0]:
        phases.append((weak_h, True))
    for base_h, widen in phases:
        for r in range(n_rounds):
            arena = _merge_round(state, planes, arena, stats, merge_pcs,
                                 mem_pcs, mem_words, base_h, r % 2, widen)
    _merge_blocked(state, planes, stats)
    return state, planes, arena, stats


def merge_pass(state: StateBatch, planes: SymPlanes, arena: A.Arena,
               merge_pcs, mem_pcs=None, mem_words=None, n_rounds: int = 6):
    """Collapse reconverged fork siblings: kernel K10 (K3's allocations
    folded in) on CUDA tensors, one host call making its launches, the
    plain twin on CPU tensors; in place either way."""
    if state.pc.is_cuda:
        from ..kernels import ops

        merge_pcs, mem_pcs, mem_words = _merge_tables(
            merge_pcs, mem_pcs, mem_words, state.pc.device)
        return ops.merge_pass(state, planes, arena, merge_pcs, mem_pcs,
                              mem_words, n_rounds)
    return merge_pass_reference(state, planes, arena, merge_pcs, mem_pcs,
                                mem_words, n_rounds)
