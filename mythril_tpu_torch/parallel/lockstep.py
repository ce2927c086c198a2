"""The lockstep batched EVM interpreter (port of mythril_tpu/parallel/lockstep.py).

`step` advances every running lane by one instruction. On CUDA tensors it
launches kernel K2 (`kernels/evm_step.cu`: one thread per lane evaluates its
own opcode with the `__device__` word arithmetic of `kernels/words.cuh`),
which in turn hands SHA3 lanes to kernel K1. On CPU tensors it runs
`step_reference`, the plain PyTorch twin that evaluates the opcode families
as masked tensor ops the way the JAX step does (lockstep.py:159-614).

Semantics are the JAX step's, bit for bit: lower-bound gas (static minimum
plus quadratic memory expansion), EVM division edge cases, bytes beyond
`msize` read as 0, table inserts into the first matching or free slot,
masked and out-of-capacity writes dropped, and lanes forced out by the
symbolic pre-pass (`force_escape`/`force_fork`) take no effects."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.opcodes import ADDRESS, GAS, OPCODES, STACK
from . import keccak, words
from .batch import (ERRORED, ESCAPED, FORKING, RETURNED, REVERTED, RUNNING,
                    STOPPED, StateBatch)

I32 = torch.int32
I64 = torch.int64

# -- static opcode tables -------------------------------------------------------------

O = {name: meta[ADDRESS] for name, meta in OPCODES.items()}

POPS = np.zeros(256, dtype=np.int32)
PUSHES = np.zeros(256, dtype=np.int32)
GAS_MIN = np.zeros(256, dtype=np.int64)
VALID = np.zeros(256, dtype=bool)
for _name, _meta in OPCODES.items():
    _byte = _meta[ADDRESS]
    VALID[_byte] = True
    POPS[_byte] = _meta[STACK][0]
    PUSHES[_byte] = _meta[STACK][1]
    GAS_MIN[_byte] = _meta[GAS][0]

# ops the lockstep engine hands back to the host oracle
ESCAPE_OPS = np.zeros(256, dtype=bool)
for _name in ["CALL", "CALLCODE", "DELEGATECALL", "STATICCALL", "CREATE",
              "CREATE2", "SELFDESTRUCT", "EXTCODESIZE", "EXTCODECOPY",
              "EXTCODEHASH", "BLOCKHASH", "BALANCE", "LOG0", "LOG1", "LOG2",
              "LOG3", "LOG4"]:
    ESCAPE_OPS[O[_name]] = True

SHA3_MAX = 512       # max on-device keccak input per lane (bytes)
COPY_MAX = 512       # max bytes moved per copy instruction on device

_TABLES = {}


def tables(device) -> dict:
    """The opcode tables as tensors on `device` (cached per device)."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = {
            "pops": torch.from_numpy(POPS.astype(np.int64)).to(device),
            "pushes": torch.from_numpy(PUSHES.astype(np.int64)).to(device),
            "gas_min": torch.from_numpy(GAS_MIN).to(device),
            "valid": torch.from_numpy(VALID).to(device),
            "escape": torch.from_numpy(ESCAPE_OPS).to(device),
        }
    return _TABLES[key]


def _i64_to_word(x: torch.Tensor) -> torch.Tensor:
    """Non-negative int per lane -> word (low 64 bits)."""
    x = x.to(I64)
    out = torch.zeros(x.shape + (words.NLIMBS,), dtype=I64, device=x.device)
    for i in range(4):
        out[..., i] = (x >> (16 * i)) & 0xFFFF
    return out


def word_to_i64(word: torch.Tensor):
    """Word -> (low 32 bits as int64, fits flag: no bit >= 2^32 set)."""
    low = word[..., 0] | (word[..., 1] << 16)
    fits = torch.all(word[..., 2:] == 0, dim=-1)
    return low, fits


def lane_limbs(t: torch.Tensor) -> torch.Tensor:
    """Stored uint32 limb bytes (int32 tensor) -> int64 limb values."""
    return t.to(I64) & 0xFFFFFFFF


def peek(state: StateBatch, n) -> torch.Tensor:
    """n-th word from the top (n=1 is top) as int64 limbs; n int or [B]."""
    slots = state.stack.shape[1]
    idx = (state.sp.to(I64) - n).clamp(0, slots - 1)
    got = torch.gather(state.stack, 1,
                       idx[:, None, None].expand(-1, 1, words.NLIMBS))
    return lane_limbs(got[:, 0, :])


def _gather_bytes(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(buf, 1, idx.clamp(0, buf.shape[1] - 1))


def mem_read(memory, msize, offset, nbytes: int) -> torch.Tensor:
    """nbytes at per-lane offset; bytes at or beyond msize read 0."""
    idx = offset.to(I64)[:, None] + torch.arange(nbytes, device=memory.device)
    vals = _gather_bytes(memory, idx)
    ok = (idx >= 0) & (idx < msize.to(I64)[:, None])
    return torch.where(ok, vals, torch.zeros_like(vals))


def mem_write(memory, lane_mask, offset, data, size=None) -> torch.Tensor:
    """Masked write of data[B, n] to memory[lane, offset:offset+n]; masked
    and out-of-capacity bytes are dropped, never clipped onto live cells."""
    batch, m = memory.shape
    n = data.shape[1]
    j = torch.arange(n, device=memory.device)
    idx = offset.to(I64)[:, None] + j
    write = lane_mask[:, None] & (idx >= 0) & (idx < m)
    if size is not None:
        write = write & (j < size.to(I64)[:, None])
    padded = torch.cat([memory, torch.zeros_like(memory[:, :1])], dim=1)
    padded.scatter_(1, torch.where(write, idx, m), data.to(memory.dtype))
    return padded[:, :m].contiguous()


def _table_match(keys, used, key):
    return used & torch.all(lane_limbs(keys) == key[:, None, :], dim=-1)


def table_get(keys, vals, used, key):
    """(found[B], value[B,16]) for a (key, value) word table [B,K,16]."""
    match = _table_match(keys, used, key)
    value = torch.where(match[..., None], lane_limbs(vals), 0).sum(1)
    return torch.any(match, dim=-1), value & 0xFFFFFFFF


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), the
    argmax rule of the JAX package."""
    return torch.argmax(mask.to(I32), dim=-1)


def table_set(keys, vals, used, lane_mask, key, value):
    """Insert/update key->value where lane_mask into the first matching
    slot, else the first free one. Returns (keys, vals, used, full)."""
    match = _table_match(keys, used, key)
    found = torch.any(match, dim=-1)
    slot = torch.where(found, first_true(match), first_true(~used))
    full = lane_mask & ~found & torch.all(used, dim=-1)
    do = lane_mask & ~full
    lane = torch.arange(keys.shape[0], device=keys.device)
    keys, vals, used = keys.clone(), vals.clone(), used.clone()
    keys[lane, slot] = torch.where(do[:, None], key.to(I32), keys[lane, slot])
    vals[lane, slot] = torch.where(do[:, None], value.to(I32),
                                   vals[lane, slot])
    used[lane, slot] = torch.where(do, True, used[lane, slot])
    return keys, vals, used, full


def _masked(fn, mask, batch_shape_like, *args):
    """fn(*args) on the lanes of `mask` only (zeros elsewhere): the
    expensive families run on the lanes that execute them."""
    out = torch.zeros_like(batch_shape_like)
    idx = torch.nonzero(mask).flatten()
    if idx.numel():
        out[idx] = fn(*[arg[idx] for arg in args])
    return out


def step_reference(state: StateBatch, force_escape: Optional[torch.Tensor] = None,
                   force_fork: Optional[torch.Tensor] = None) -> StateBatch:
    """Plain PyTorch twin of kernel K2: one instruction for every lane."""
    dev = state.stack.device
    tab = tables(dev)
    batch, slots = state.stack.shape[0], state.stack.shape[1]
    mem_cap = state.memory.shape[1]
    running = state.status == RUNNING
    if force_escape is not None:
        running = running & ~force_escape & ~force_fork
    lane = torch.arange(batch, device=dev)
    pc = state.pc.to(I64)
    sp = state.sp.to(I64)
    msize = state.msize.to(I64)

    # ---- fetch ----------------------------------------------------------------------
    in_code = state.pc < state.code_len
    op = torch.where(in_code, _gather_bytes(state.code, pc[:, None])[:, 0]
                     .to(I64), O["STOP"])

    def is_op(name):
        return op == O[name]

    def op_in(*names):
        mask = torch.zeros_like(running)
        for name in names:
            mask = mask | (op == O[name])
        return mask

    # ---- validity / stack preflight --------------------------------------------------
    pops = tab["pops"][op]
    pushes = tab["pushes"][op]
    invalid = ~tab["valid"][op]
    underflow = sp < pops
    new_sp = sp - pops + pushes
    overflow_cap = new_sp > slots
    overflow_evm = new_sp > 1024
    escape = tab["escape"][op]

    a = peek(state, 1)
    b = peek(state, 2)
    c = peek(state, 3)
    zero_w = torch.zeros_like(a)

    # ---- memory ranges + expansion gas ----------------------------------------------
    off_word = torch.where(op_in("MLOAD", "MSTORE", "MSTORE8", "SHA3",
                                 "CALLDATACOPY", "CODECOPY", "RETURNDATACOPY",
                                 "RETURN", "REVERT")[:, None], a, 0)
    size_is_c = op_in("CALLDATACOPY", "CODECOPY", "RETURNDATACOPY", "MCOPY")
    size_is_b = op_in("SHA3", "RETURN", "REVERT")
    size_word = torch.where(size_is_c[:, None], c,
                            torch.where(size_is_b[:, None], b, 0))
    fixed32 = op_in("MLOAD", "MSTORE")
    fixed1 = is_op("MSTORE8")
    mcopy_off = torch.where(words.lt(a, b)[:, None], b, a)
    off_word = torch.where(is_op("MCOPY")[:, None], mcopy_off, off_word)

    off_i, off_fits = word_to_i64(off_word)
    size_i, size_fits = word_to_i64(size_word)
    size_i = torch.where(fixed32, 32, torch.where(fixed1, 1, size_i))
    size_fits = size_fits | fixed32 | fixed1
    touches_mem = size_i > 0
    mem_end = off_i + size_i
    mem_oog = touches_mem & (~off_fits | ~size_fits | (mem_end > 2 ** 32))
    mem_escape = touches_mem & ~mem_oog & (mem_end > mem_cap)

    after_bytes = torch.maximum(msize, ((mem_end + 31) // 32) * 32)
    after_bytes = torch.where(touches_mem & ~mem_oog & ~mem_escape,
                              after_bytes, msize)
    before_w = msize // 32
    after_w = after_bytes // 32
    mem_gas = torch.where(after_w > before_w,
                          3 * (after_w - before_w) + (after_w * after_w) // 512
                          - (before_w * before_w) // 512, 0)
    new_msize = after_bytes

    # ---- gas (lower-bound model) -------------------------------------------------------
    new_gas_used = state.gas_used + tab["gas_min"][op] + mem_gas
    oog = new_gas_used > state.gas_limit

    # ---- expensive families, on the lanes that execute them ---------------------------
    div_like = running & op_in("DIV", "SDIV", "MOD", "SMOD")

    def _div_family(a, b, op):
        signed = (op == O["SDIV"]) | (op == O["SMOD"])
        sa = words.sign_bit(a) == 1
        sb = words.sign_bit(b) == 1
        na = torch.where((signed & sa)[:, None], words.neg(a), a)
        nb = torch.where((signed & sb)[:, None], words.neg(b), b)
        q, r = words._divmod_bits(na, nb, words.WORD_BITS)
        sdiv_q = torch.where((sa ^ sb)[:, None], words.neg(q), q)
        smod_r = torch.where(sa[:, None], words.neg(r), r)
        res = torch.where((op == O["DIV"])[:, None], q,
              torch.where((op == O["MOD"])[:, None], r,
              torch.where((op == O["SDIV"])[:, None], sdiv_q, smod_r)))
        return torch.where(words.is_zero(b)[:, None], 0, res)

    div_res = _masked(_div_family, div_like, a, a, b, op)
    addmod_mask = running & is_op("ADDMOD")
    addmod_res = _masked(words.addmod, addmod_mask, a, a, b, c)
    mulmod_mask = running & is_op("MULMOD")
    mulmod_res = _masked(words.mulmod, mulmod_mask, a, a, b, c)
    exp_mask = running & is_op("EXP")
    exp_res = _masked(words.exp, exp_mask, a, a, b)
    mul_mask = running & is_op("MUL")
    mul_res = words.mul(a, b)

    sha_mask = running & is_op("SHA3")
    sha_len_i, sha_len_fits = word_to_i64(b)
    sha_escape = sha_mask & (~sha_len_fits | (sha_len_i > SHA3_MAX))
    sha_do = sha_mask & ~sha_escape
    if bool(sha_do.any()):
        buf = mem_read(state.memory, state.msize, off_i, SHA3_MAX)
        digest = keccak.keccak256_reference(
            buf, sha_len_i.clamp(0, SHA3_MAX).to(I32))
        sha_res = words.from_bytes(digest)
    else:
        sha_res = zero_w

    sload_mask = running & is_op("SLOAD")
    sload_res = table_get(state.storage_keys, state.storage_vals,
                          state.storage_used, a)[1]
    tload_mask = running & is_op("TLOAD")
    tload_res = table_get(state.tstore_keys, state.tstore_vals,
                          state.tstore_used, a)[1]
    mload_mask = running & is_op("MLOAD")
    mload_res = words.from_bytes(mem_read(state.memory, new_msize, off_i, 32))

    # CALLDATALOAD: 32-byte big-endian read, out of range zero-padded
    cdl_off, cdl_fits = word_to_i64(a)
    j32 = torch.arange(32, device=dev)
    cdl_idx = cdl_off[:, None] + j32
    cdl_bytes = _gather_bytes(state.calldata, cdl_idx)
    cdl_bytes = torch.where(
        cdl_fits[:, None] & (cdl_idx < state.calldata_len.to(I64)[:, None]),
        cdl_bytes, torch.zeros_like(cdl_bytes))
    cdl_res = words.from_bytes(cdl_bytes)

    # PUSH immediates: code[pc+1 : pc+1+n], right-aligned in 32 bytes
    imm_len = (op - 0x5F).clamp(0, 32)
    src = pc[:, None] + 1 + j32 - (32 - imm_len[:, None])
    push_bytes = _gather_bytes(state.code, src)
    push_bytes = torch.where((src >= pc[:, None] + 1)
                             & (src < state.code_len.to(I64)[:, None]),
                             push_bytes, torch.zeros_like(push_bytes))
    push_res = words.from_bytes(push_bytes)

    dup_res = peek(state, (op - 0x7F).clamp(1, 16))

    is_push = (op >= 0x5F) & (op <= 0x7F)
    is_dup = (op >= 0x80) & (op <= 0x8F)
    is_swap = (op >= 0x90) & (op <= 0x9F)

    # ---- result select ---------------------------------------------------------------
    def env(name):
        return lane_limbs(getattr(state, name))

    candidates = [
        (is_op("ADD"), lambda: words.add(a, b)),
        (is_op("SUB"), lambda: words.sub(a, b)),
        (mul_mask, lambda: mul_res),
        (div_like, lambda: div_res),
        (addmod_mask, lambda: addmod_res),
        (mulmod_mask, lambda: mulmod_res),
        (exp_mask, lambda: exp_res),
        (is_op("SIGNEXTEND"), lambda: words.signextend(a, b)),
        (is_op("LT"), lambda: words.bool_to_word(words.lt(a, b))),
        (is_op("GT"), lambda: words.bool_to_word(words.gt(a, b))),
        (is_op("SLT"), lambda: words.bool_to_word(words.slt(a, b))),
        (is_op("SGT"), lambda: words.bool_to_word(words.sgt(a, b))),
        (is_op("EQ"), lambda: words.bool_to_word(words.eq(a, b))),
        (is_op("ISZERO"), lambda: words.bool_to_word(words.is_zero(a))),
        (is_op("AND"), lambda: a & b),
        (is_op("OR"), lambda: a | b),
        (is_op("XOR"), lambda: a ^ b),
        (is_op("NOT"), lambda: words.bnot(a)),
        (is_op("BYTE"), lambda: words.byte_op(a, b)),
        (is_op("SHL"), lambda: words.shl(a, b)),
        (is_op("SHR"), lambda: words.shr(a, b)),
        (is_op("SAR"), lambda: words.sar(a, b)),
        (sha_mask, lambda: sha_res),
        (is_op("ADDRESS"), lambda: env("address")),
        (is_op("ORIGIN"), lambda: env("origin")),
        (is_op("CALLER"), lambda: env("caller")),
        (is_op("CALLVALUE"), lambda: env("callvalue")),
        (is_op("CALLDATALOAD"), lambda: cdl_res),
        (is_op("CALLDATASIZE"), lambda: _i64_to_word(state.calldata_len)),
        (is_op("CODESIZE"), lambda: _i64_to_word(state.code_len)),
        (is_op("GASPRICE"), lambda: env("gasprice")),
        (is_op("RETURNDATASIZE"), lambda: _i64_to_word(state.retdata_len)),
        (is_op("COINBASE"), lambda: env("coinbase")),
        (is_op("TIMESTAMP"), lambda: env("timestamp")),
        (is_op("NUMBER"), lambda: env("number")),
        (is_op("PREVRANDAO"), lambda: env("prevrandao")),
        (is_op("GASLIMIT"), lambda: env("block_gaslimit")),
        (is_op("CHAINID"), lambda: env("chainid")),
        (is_op("SELFBALANCE"), lambda: env("selfbalance")),
        (is_op("BASEFEE"), lambda: env("basefee")),
        (is_op("BLOBHASH"), lambda: zero_w),
        (is_op("BLOBBASEFEE"), lambda: zero_w),
        (is_op("PC"), lambda: _i64_to_word(pc)),
        (is_op("MSIZE"), lambda: _i64_to_word(new_msize)),
        (is_op("GAS"), lambda: _i64_to_word(
            (state.gas_limit - new_gas_used).clamp(min=0))),
        (mload_mask, lambda: mload_res),
        (sload_mask, lambda: sload_res),
        (tload_mask, lambda: tload_res),
        (is_push, lambda: push_res),
        (is_dup, lambda: dup_res),
    ]
    result = zero_w
    for mask, cand in candidates:
        if bool(mask.any()):
            result = torch.where(mask[:, None], cand(), result)

    # ---- stack update ----------------------------------------------------------------
    writes_result = (pushes >= 1) & ~is_swap
    write_idx = (new_sp - 1).clamp(0, slots - 1)
    new_stack = state.stack.clone()
    old_top = new_stack[lane, write_idx]
    new_stack[lane, write_idx] = torch.where(
        (running & writes_result)[:, None], result.to(I32), old_top)
    swap_n = (op - 0x8F).clamp(1, 16)
    swap_do = running & is_swap
    top_idx = (sp - 1).clamp(0, slots - 1)
    deep_idx = (sp - 1 - swap_n).clamp(0, slots - 1)
    top_val = new_stack[lane, top_idx]
    deep_val = new_stack[lane, deep_idx]
    new_stack[lane, top_idx] = torch.where(swap_do[:, None], deep_val, top_val)
    new_stack[lane, deep_idx] = torch.where(swap_do[:, None], top_val,
                                            deep_val)

    # ---- memory writes ---------------------------------------------------------------
    new_memory = state.memory
    mstore_mask = running & is_op("MSTORE") & ~mem_oog & ~mem_escape
    if bool(mstore_mask.any()):
        new_memory = mem_write(new_memory, mstore_mask, off_i,
                               words.to_bytes(b))
    mstore8_mask = running & is_op("MSTORE8") & ~mem_oog & ~mem_escape
    if bool(mstore8_mask.any()):
        new_memory = mem_write(new_memory, mstore8_mask, off_i,
                               (b[:, 0] & 0xFF).to(torch.uint8)[:, None])

    copy_mask = running & op_in("CALLDATACOPY", "CODECOPY", "RETURNDATACOPY",
                                "MCOPY") & ~mem_oog & ~mem_escape
    copy_src_off, copy_src_fits = word_to_i64(b)
    copy_len = torch.where(copy_mask, size_i, 0)
    copy_escape = copy_mask & (copy_len > COPY_MAX)
    copy_do = copy_mask & ~copy_escape
    if bool(copy_do.any()):
        src_idx = copy_src_off[:, None] + torch.arange(COPY_MAX, device=dev)

        def bounded(buf, length):
            got = _gather_bytes(buf, src_idx)
            ok = copy_src_fits[:, None] & (src_idx < length.to(I64)[:, None])
            return torch.where(ok, got, torch.zeros_like(got))

        cd = bounded(state.calldata, state.calldata_len)
        co = bounded(state.code, state.code_len)
        rd = bounded(state.retdata, state.retdata_len)
        mm = mem_read(new_memory, state.msize, copy_src_off, COPY_MAX)
        src_bytes = torch.where(is_op("CALLDATACOPY")[:, None], cd,
                    torch.where(is_op("CODECOPY")[:, None], co,
                    torch.where(is_op("RETURNDATACOPY")[:, None], rd, mm)))
        dst_off = torch.where(is_op("MCOPY"), word_to_i64(a)[0], off_i)
        new_memory = mem_write(new_memory, copy_do, dst_off, src_bytes,
                               size=copy_len)

    # ---- storage writes --------------------------------------------------------------
    sstore_mask = running & is_op("SSTORE")
    tstore_mask = running & is_op("TSTORE")
    no_lane = torch.zeros_like(running)
    storage_keys, storage_vals, storage_used, sstore_full = (
        table_set(state.storage_keys, state.storage_vals, state.storage_used,
                  sstore_mask, a, b) if bool(sstore_mask.any())
        else (state.storage_keys, state.storage_vals, state.storage_used,
              no_lane))
    tstore_keys, tstore_vals, tstore_used, tstore_full = (
        table_set(state.tstore_keys, state.tstore_vals, state.tstore_used,
                  tstore_mask, a, b) if bool(tstore_mask.any())
        else (state.tstore_keys, state.tstore_vals, state.tstore_used,
              no_lane))

    # ---- control flow ----------------------------------------------------------------
    next_pc = pc + 1 + torch.where(is_push, imm_len, 0)
    jump_dest_i, jump_fits = word_to_i64(a)
    jump_dest = jump_dest_i.clamp(0, state.code.shape[1] - 1)
    dest_ok = jump_fits & (jump_dest_i < state.code_len.to(I64)) & \
        torch.gather(state.jumpdest, 1, jump_dest[:, None])[:, 0]
    take_jumpi = is_op("JUMPI") & ~words.is_zero(b)
    jumping = is_op("JUMP") | take_jumpi
    bad_jump = jumping & ~dest_ok
    next_pc = torch.where(jumping & dest_ok, jump_dest, next_pc)

    # ---- halting ---------------------------------------------------------------------
    ret_mask = running & op_in("RETURN", "REVERT") & ~mem_oog & ~mem_escape
    ret_len = torch.where(ret_mask, size_i, 0)
    ret_cap = state.retdata.shape[1]
    ret_escape = ret_mask & (ret_len > ret_cap)
    ret_do = ret_mask & ~ret_escape
    new_retdata = state.retdata
    if bool(ret_do.any()):
        payload = mem_read(state.memory, new_msize, off_i, ret_cap)
        write = ret_do[:, None] & (torch.arange(ret_cap, device=dev)
                                   < ret_len[:, None])
        new_retdata = torch.where(write, payload, state.retdata)
    new_retdata_len = torch.where(ret_do, ret_len, state.retdata_len.to(I64))

    # ---- status resolution (errors > escapes > halts) -------------------------------
    new_status = torch.full_like(state.status, RUNNING)
    new_status = torch.where(is_op("STOP") | (ret_do & is_op("RETURN")),
                             torch.where(is_op("STOP"), STOPPED, RETURNED)
                             .to(I32), new_status)
    new_status = torch.where(ret_do & is_op("REVERT"), REVERTED, new_status)
    wants_escape = (escape | overflow_cap | mem_escape | sha_escape
                    | copy_escape | ret_escape | sstore_full | tstore_full)
    new_status = torch.where(wants_escape, ESCAPED, new_status)
    is_error = (invalid | underflow | overflow_evm | oog | mem_oog | bad_jump
                | is_op("INVALID"))
    new_status = torch.where(is_error, ERRORED, new_status).to(I32)

    if force_escape is not None:
        was_running = state.status == RUNNING
        forced = torch.where(was_running & force_fork, FORKING,
                             torch.where(was_running & force_escape, ESCAPED,
                                         state.status)).to(I32)
        status = torch.where(running, new_status, forced)
    else:
        status = torch.where(running, new_status, state.status)

    commit = running & ~is_error & ~wants_escape

    def adv(new, old):
        mask = commit.reshape(commit.shape + (1,) * (old.dim() - 1))
        return torch.where(mask, new.to(old.dtype), old)

    return state._replace(
        stack=adv(new_stack, state.stack),
        sp=adv(new_sp, state.sp),
        pc=adv(next_pc, state.pc),
        gas_used=adv(new_gas_used, state.gas_used),
        status=status,
        memory=adv(new_memory, state.memory),
        msize=adv(new_msize, state.msize),
        retdata=adv(new_retdata, state.retdata),
        retdata_len=adv(new_retdata_len, state.retdata_len),
        storage_keys=adv(storage_keys, state.storage_keys),
        storage_vals=adv(storage_vals, state.storage_vals),
        storage_used=adv(storage_used, state.storage_used),
        tstore_keys=adv(tstore_keys, state.tstore_keys),
        tstore_vals=adv(tstore_vals, state.tstore_vals),
        tstore_used=adv(tstore_used, state.tstore_used),
    )


def step(state: StateBatch, force_escape: Optional[torch.Tensor] = None,
         force_fork: Optional[torch.Tensor] = None) -> StateBatch:
    """One instruction for every lane: kernel K2 on CUDA tensors (which
    updates the state's tensors in place and returns the same batch), the
    plain twin on CPU tensors."""
    if state.stack.is_cuda:
        from ..kernels import ops

        return ops.evm_step(state, force_escape, force_fork)
    return step_reference(state, force_escape, force_fork)


def step_many(state: StateBatch, n_steps: int) -> StateBatch:
    """n_steps lockstep steps."""
    for _ in range(n_steps):
        state = step(state)
    return state


def run(state: StateBatch, max_steps: int = 100_000, chunk: int = 64,
        escape_on_budget: bool = True) -> StateBatch:
    """Step in chunks until every lane halted (or the budget ran out); lanes
    still RUNNING at the budget are marked ESCAPED for the host oracle."""
    steps = 0
    while steps < max_steps:
        state = step_many(state, chunk)
        steps += chunk
        if not bool(torch.any(state.status == RUNNING)):
            break
    if escape_on_budget:
        state = state._replace(status=torch.where(
            state.status == RUNNING, ESCAPED, state.status).to(I32))
    return state
