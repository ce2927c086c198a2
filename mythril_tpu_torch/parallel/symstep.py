"""Symbolic lockstep, core (port of mythril_tpu/parallel/symstep.py:186-1001).

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

On CUDA tensors `sym_step` runs kernel K4 (`kernels/sym_step.cu`: a pre-pass
launch, two small glue launches and a post-pass launch, each one block with
a thread per lane and block-wide scans for every rank) around kernels K2
and K3 (and K1 through K2); it updates every tensor in place. On CPU
tensors it runs `sym_step_reference`, the plain twin, which rebuilds the
lane state and updates the scheduler pools and the arena in place.

Only the single-shard scheduler without telemetry is ported: anything else
raises NotImplementedError."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from . import arena as A
from . import lockstep, words
from .batch import DEAD, ERRORED, ESCAPED, FORKING, RUNNING, StateBatch

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

_TABLES = {}


def _tables(device) -> dict:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = {
            "sym_ok": torch.from_numpy(SYM_OK).to(device),
            "plumbing": torch.from_numpy(PLUMBING).to(device),
            "env_class": torch.from_numpy(ENV_CLASS.astype(np.int64))
            .to(device),
        }
    return _TABLES[key]


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
    stack_top: torch.Tensor    # int32[] rows used
    esc_state: StateBatch      # [E] escaped rows
    esc_planes: SymPlanes
    esc_count: torch.Tensor    # int32[] rows used
    executed: torch.Tensor     # int64[] instruction-states stepped
    forks: torch.Tensor        # int64[] fork events (claims + pushes + spills)
    pushes: torch.Tensor       # int64[] siblings pushed to the stack
    pops: torch.Tensor         # int64[] siblings reseeded from the stack
    enabled: torch.Tensor      # bool[] False = freeze/escape semantics
    telemetry: Optional[object] = None
    steals_sent: Optional[torch.Tensor] = None
    steals_received: Optional[torch.Tensor] = None
    steal_rows: Optional[torch.Tensor] = None


def new_scheduler(state: StateBatch, planes: SymPlanes, stack_rows: int,
                  esc_rows: int, disabled: bool = False,
                  telemetry=None, n_shards: int = 1) -> DeviceScheduler:
    """Allocate scheduler pools shaped like (state, planes) rows on the
    state's device."""
    if telemetry is not None:
        raise NotImplementedError("the telemetry plane is not ported yet")
    if n_shards != 1:
        raise NotImplementedError("sharded schedulers are not ported yet")
    dev = state.stack.device

    def rows(leaf, n):
        return torch.zeros((n,) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                           device=dev)

    def scalar(value, dtype):
        return torch.tensor(value, dtype=dtype, device=dev)

    return DeviceScheduler(
        stack_state=StateBatch(*[rows(leaf, stack_rows) for leaf in state]),
        stack_planes=SymPlanes(*[rows(leaf, stack_rows) for leaf in planes]),
        stack_top=scalar(0, I32),
        esc_state=StateBatch(*[rows(leaf, esc_rows) for leaf in state]),
        esc_planes=SymPlanes(*[rows(leaf, esc_rows) for leaf in planes]),
        esc_count=scalar(0, I32),
        executed=scalar(0, I64),
        forks=scalar(0, I64),
        pushes=scalar(0, I64),
        pops=scalar(0, I64),
        enabled=scalar(not disabled, torch.bool),
    )


def _check_scheduler(sched: DeviceScheduler) -> None:
    if sched.telemetry is not None or sched.stack_top.dim() != 0:
        raise NotImplementedError(
            "only the single-shard scheduler without telemetry is ported")


def _where_rows(mask, rows, leaf):
    return torch.where(mask.reshape(mask.shape + (1,) * (leaf.dim() - 1)),
                       rows, leaf)


def _rank(mask: torch.Tensor) -> torch.Tensor:
    """0-based rank of each True lane among the True lanes."""
    return torch.cumsum(mask.to(I64), 0) - 1


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

    state = state._replace(status=torch.where(
        state.status == ERRORED, DEAD, state.status).to(I32))

    # ---- reseed DEAD lanes from the sibling stack (deepest first) -------------------
    pool_rows = sched.stack_state.status.shape[0]
    top = sched.stack_top.to(I64)
    dead0 = state.status == DEAD
    rrank = _rank(dead0)
    take = dead0 & (rrank < top) & enabled
    src = (top - 1 - rrank).clamp(0, max(pool_rows - 1, 0))
    if bool(take.any()):
        state = StateBatch(*[_where_rows(take, pool[src], leaf)
                             for leaf, pool in zip(state, sched.stack_state)])
        planes = SymPlanes(*[_where_rows(take, pool[src], leaf)
                             for leaf, pool in zip(planes,
                                                   sched.stack_planes)])
    n_taken = take.sum()
    running = state.status == RUNNING
    sched = sched._replace(stack_top=(top - n_taken).to(I32),
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
    esc = esc | (running & reads_mem & (sym1 == 0) & (sym2 == 0)
                 & _range_has_sym(planes.mem_sym, off_i,
                                  size_for_read.clamp(0, mem_cap)))
    esc = esc | (running & symbolic_env & is_op("CALLDATACOPY"))
    esc = esc | (running & symbolic_env & is_op("SELFBALANCE"))
    copy_size_i = lockstep.word_to_i64(lockstep.peek(state, 3))[0]
    esc = esc | (running & (is_op("CODECOPY") | is_op("RETURNDATACOPY"))
                 & _range_has_sym(planes.mem_sym, off_i,
                                  copy_size_i.clamp(0, mem_cap)))
    esc = esc | (running & is_op("MCOPY")
                 & torch.any(planes.mem_sym != 0, dim=1))
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
    ecount = sched.esc_count.to(I64)
    esc_now = (new_state.status == ESCAPED) & enabled
    erank = _rank(esc_now)
    put = esc_now & (erank < esc_rows - ecount)
    eslot = ecount + erank
    for pool, leaf in zip(list(sched.esc_state) + list(sched.esc_planes),
                          list(new_state) + list(new_planes)):
        _put_rows(pool, eslot, put, leaf)
    esc_used = ecount + put.sum()
    new_state = new_state._replace(
        status=torch.where(put, DEAD, new_state.status).to(I32))

    # ---- on-device JUMPI forking ----------------------------------------------------
    max_conds = planes.conds.shape[1]
    want = jumpi_fork | frozen_fork
    is_dead = new_state.status == DEAD
    dead_map = torch.zeros(batch + 1, dtype=I64, device=dev)
    dead_map[torch.where(is_dead, _rank(is_dead), batch)] = lane
    fork_rank = _rank(want)
    have_target = want & (fork_rank < is_dead.sum())
    target = dead_map[fork_rank.clamp(0, batch - 1)]
    top2 = sched.stack_top.to(I64)
    push_want = want & ~have_target & enabled
    push_rank = _rank(push_want)
    push = push_want & (push_rank < pool_rows - top2)
    spill_want = push_want & ~push
    spill_rank = _rank(spill_want)
    spill = spill_want & (spill_rank < esc_rows - esc_used)
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
        _put_rows(pool, top2 + push_rank, push, sib)
    for pool, sib in zip(list(sched.esc_state) + list(sched.esc_planes),
                         sib_leaves):
        _put_rows(pool, esc_used + spill_rank, spill, sib)
    n_push = push.sum()
    sched = sched._replace(
        stack_top=(top2 + n_push).to(I32),
        esc_count=(esc_used + spill.sum()).to(I32),
        pushes=sched.pushes + n_push,
        forks=sched.forks + act.sum())

    # 4. forker divergence: take the jump (or die on an invalid dest)
    new_state = state_b._replace(
        pc=torch.where(act, off_i.to(I32), state_b.pc),
        status=torch.where(act, torch.where(dest_ok, RUNNING, DEAD).to(I32),
                           state_b.status))
    new_planes = planes_b._replace(
        fork_cond=torch.where(act, 0, planes_b.fork_cond).to(I32))
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
              sched: DeviceScheduler, n_steps: int):
    """n_steps symbolic steps with the on-device scheduler engaged."""
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
