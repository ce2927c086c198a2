// Kernel K2: one concrete EVM instruction for every lane.
//
// Replaces mythril_tpu/parallel/lockstep.py:159 `step` (with `step_many`,
// 617, and `run`, 623) and everything of words.py it inlines. The TPU
// program evaluates every opcode family for every lane as masked vector
// ops; here a warp owns one lane and evaluates only its own opcode, which
// is the SIMT form of the same masked evaluation. Results are the JAX
// step's bit for bit: the lower-bound gas model, EVM word semantics
// (words.cuh), bytes at or beyond msize reading 0, table inserts into the
// first matching or free slot, masked and out-of-capacity writes dropped,
// and lanes forced out by the symbolic pre-pass frozen. The state is
// updated in place: a lane commits only when it neither errs nor escapes.
//
// K1's step form (keccak.cu `keccak_step_kernel`) runs just before it on the
// same parameter block: it finds the SHA3 lanes with this file's lane
// helpers (evm_lane.cuh) and leaves their digests in K2_DIGEST, which
// `evm_step` reads only on the lanes that commit a SHA3.
//
// `evm_step` runs one block of 32 threads (a warp) per lane, so the lanes
// spread over the SMs (128 blocks at the frontier's 128 lanes). Control
// flow is uniform across a block: every thread evaluates the lane's opcode,
// preflight and status decision from the same broadcast loads (one
// instruction stream, so it is computed once), and what the threads share
// goes through shared memory between barriers that every thread reaches.
// The threads share out the lane's wide work:
//   * the three operand slots, a limb a thread;
//   * the 32 bytes of an MLOAD, CALLDATALOAD, PUSH or SHA3 digest and of an
//     MSTORE, a byte a thread, packed into limbs through shared memory;
//   * copies (CALLDATACOPY, CODECOPY, RETURNDATACOPY, MCOPY) and RETURN /
//     REVERT data, consecutive bytes on consecutive threads; MCOPY stages
//     its source (at most 512 bytes) in shared memory before any write, so
//     it reads memory as it stood;
//   * the storage and transient tables, a slot a thread: SLOAD/TLOAD sums
//     every matching used slot limb by limb (uint32 adds, exact in any
//     order), SSTORE/TSTORE takes the least matching used slot, else the
//     least free one (minima over the threads);
//   * the result word and the stack, storage and memory writes of the
//     commit, a limb or a byte a thread; thread 0 writes the scalars.
// DIV/SDIV/MOD/SMOD, ADDMOD, MULMOD, EXP and SIGNEXTEND run in thread 0,
// out of line (`heavy_word`), so their registers do not set those of the
// common path.
//
// Bound: operations for the lanes that divide, multiply or hash; otherwise
// the bytes of the few rows a lane touches.
#include "evm_lane.cuh"

namespace {

enum { STEP_THREADS = 32, COPY_LIMIT = 512, NO_SLOT = 0x7fffffff };

__device__ __forceinline__ bool is_heavy(int op) {
    return op >= OP_DIV && op <= OP_SIGNEXTEND;
}

// The division family, ADDMOD, MULMOD, EXP and SIGNEXTEND of the operands'
// stored limbs, into 16 stored limbs. One thread runs it, out of line.
MTPU_NOINLINE __device__ void heavy_word(int op, const int32_t* a16, const int32_t* b16,
                                         const int32_t* c16, uint32_t* out16) {
    const W wa = w_load16(a16), wb = w_load16(b16), wc = w_load16(c16);
    W r;
    switch (op) {
        case OP_ADDMOD: r = w_addmod(wa, wb, wc); break;
        case OP_MULMOD: r = w_mulmod(wa, wb, wc); break;
        case OP_EXP: r = w_exp(wa, wb); break;
        case OP_SIGNEXTEND: r = w_signextend(wa, wb); break;
        default: r = w_div_family(op, wa, wb); break;
    }
    w_to16(r, out16);
}

// what a block shares
struct StepShared {
    int32_t in16[3][16];      // operand words a, b, c (stored limbs)
    uint32_t res[16];         // a table read's sums, or a heavy result
    uint8_t bytes[COPY_LIMIT];  // 32 result bytes, or an MCOPY's source
    int first_match, first_free;  // a table write's minima
};

}  // namespace

__global__ void evm_step_kernel(Args a) {
    __shared__ StepShared sh;
    const int lane = blockIdx.x, t = threadIdx.x;
    const long long L = lane;
    const int S = arg_int(a, K2_S), M = arg_int(a, K2_M),
              C = arg_int(a, K2_C), D = arg_int(a, K2_D),
              R = arg_int(a, K2_R), K = arg_int(a, K2_K),
              T = arg_int(a, K2_T);
    int32_t* status_p = arg_ptr<int32_t>(a, L_STATUS) + lane;
    const int status = *status_p;
    const uint8_t* fe = arg_ptr<const uint8_t>(a, K2_FORCE_ESCAPE);
    const uint8_t* ff = arg_ptr<const uint8_t>(a, K2_FORCE_FORK);

    if (!running_of(a, lane)) {
        // forced-out lanes keep all their state; only the status moves
        if (t == 0 && fe && status == ST_RUNNING)
            *status_p = ff[lane] ? ST_FORKING : (fe[lane] ? ST_ESCAPED : status);
        return;  // the whole block
    }

    // ---- what depends on pc and sp only: the opcode, the operands (a limb a
    // thread) and the 32 code bytes after pc (a PUSH's immediate, a byte a
    // thread), all loaded side by side ---------------------------------------------
    const long long pc = arg_ptr<int32_t>(a, L_PC)[lane];
    const long long sp = arg_ptr<int32_t>(a, L_SP)[lane];
    const long long msize = arg_ptr<int32_t>(a, L_MSIZE)[lane];
    const long long code_len = arg_ptr<int32_t>(a, L_CODE_LEN)[lane];
    const uint8_t* code = arg_ptr<uint8_t>(a, L_CODE) + L * C;
    const int op = op_at(a, lane, static_cast<int>(pc));
    for (int k = t; k < 48; k += STEP_THREADS)
        sh.in16[k / 16][k % 16] = slot_ptr(a, lane, sp, k / 16 + 1)[k % 16];
    const long long next_byte = pc + 1 + t;
    const uint8_t code_byte = next_byte < code_len ? code[clampll(next_byte, 0, C - 1)] : 0;
    if (t < 16) sh.res[t] = 0;
    if (t == 0) sh.first_match = sh.first_free = NO_SLOT;
    const int32_t* optab = arg_ptr<const int32_t>(a, K2_OPTAB);
    const int pops = optab[4 * op + OPT_POPS];
    const int pushes = optab[4 * op + OPT_PUSHES];
    const int flags = optab[4 * op + OPT_FLAGS];
    __syncthreads();
    const W wa = w_load16(sh.in16[0]), wb = w_load16(sh.in16[1]),
            wc = w_load16(sh.in16[2]);

    // ---- validity / stack preflight ---------------------------------------------
    const bool invalid = !(flags & OPF_VALID);
    const bool underflow = sp < pops;
    const long long new_sp = sp - pops + pushes;
    const bool overflow_cap = new_sp > S;
    const bool overflow_evm = new_sp > 1024;
    const bool escape_op = flags & OPF_ESCAPE;

    // ---- memory ranges + expansion gas ------------------------------------------
    const bool is_copy = op == OP_CALLDATACOPY || op == OP_CODECOPY
                         || op == OP_RETURNDATACOPY || op == OP_MCOPY;
    const bool off_is_a = op == OP_MLOAD || op == OP_MSTORE || op == OP_MSTORE8
                          || op == OP_SHA3 || op == OP_CALLDATACOPY
                          || op == OP_CODECOPY || op == OP_RETURNDATACOPY
                          || op == OP_RETURN || op == OP_REVERT;
    const bool size_is_b = op == OP_SHA3 || op == OP_RETURN || op == OP_REVERT;
    W off_word = off_is_a ? wa : w_zero();
    if (op == OP_MCOPY) off_word = w_lt(wa, wb) ? wb : wa;
    const W size_word = is_copy ? wc : (size_is_b ? wb : w_zero());
    bool off_fits, size_fits;
    const long long off_i = w_low32(off_word, &off_fits);
    long long size_i = w_low32(size_word, &size_fits);
    if (op == OP_MLOAD || op == OP_MSTORE) { size_i = 32; size_fits = true; }
    if (op == OP_MSTORE8) { size_i = 1; size_fits = true; }
    const bool touches = size_i > 0;
    const long long mem_end = off_i + size_i;
    const bool mem_oog = touches && (!off_fits || !size_fits
                                     || mem_end > (1LL << 32));
    const bool mem_escape = touches && !mem_oog && mem_end > M;
    long long after = msize;
    if (touches && !mem_oog && !mem_escape) {
        long long need = ((mem_end + 31) / 32) * 32;
        after = need > msize ? need : msize;
    }
    const long long before_w = msize / 32, after_w = after / 32;
    const long long mem_gas = after_w > before_w
        ? 3 * (after_w - before_w) + (after_w * after_w) / 512
          - (before_w * before_w) / 512
        : 0;
    const long long new_msize = after;
    const long long gas_used = arg_ptr<long long>(a, L_GAS_USED)[lane];
    const long long gas_limit = arg_ptr<long long>(a, L_GAS_LIMIT)[lane];
    const long long new_gas = gas_used + optab[4 * op + OPT_GAS] + mem_gas;
    const bool oog = new_gas > gas_limit;

    uint8_t* memory = arg_ptr<uint8_t>(a, L_MEMORY) + L * M;
    auto mem_byte = [&](long long idx, long long limit) -> uint8_t {
        return (idx >= 0 && idx < limit) ? memory[idx] : 0;
    };

    // ---- SHA3 escape (the digest came from K1) ----------------------------------
    bool sha_escape = false;
    if (op == OP_SHA3) {
        bool fits;
        long long n = w_low32(wb, &fits);
        sha_escape = !fits || n > 512;
    }

    // ---- copies and returns ---------------------------------------------------------
    const bool mem_ok = !mem_oog && !mem_escape;
    const bool copy_mask = is_copy && mem_ok;
    const long long copy_len = copy_mask ? size_i : 0;
    const bool copy_escape = copy_mask && copy_len > COPY_LIMIT;
    const bool ret_mask = (op == OP_RETURN || op == OP_REVERT) && mem_ok;
    const long long ret_len = ret_mask ? size_i : 0;
    const bool ret_escape = ret_mask && ret_len > R;
    const bool ret_do = ret_mask && !ret_escape;

    // ---- control flow ------------------------------------------------------------
    const bool is_push = op >= 0x5F && op <= 0x7F;
    const bool is_dup = op >= 0x80 && op <= 0x8F;
    const bool is_swap = op >= 0x90 && op <= 0x9F;
    const int imm_len = is_push ? op - 0x5F : 0;
    long long next_pc = pc + 1 + imm_len;
    bool jump_fits;
    const long long jump_dest_i = w_low32(wa, &jump_fits);
    const long long jump_dest = clampll(jump_dest_i, 0, C - 1);
    const bool jumping = op == OP_JUMP || (op == OP_JUMPI && !w_is_zero(wb));
    const bool dest_ok = jumping && jump_fits && jump_dest_i < code_len
        && arg_ptr<uint8_t>(a, L_JUMPDEST)[L * C + jump_dest];

    // ---- what depends on the opcode and the operands, loaded side by side:
    // the tables (a slot a thread), 32 result bytes (a byte a thread), a
    // DUP's or an env word's limb, MCOPY's source; a heavy word in thread 0 ---
    const bool st_op = op == OP_SSTORE || op == OP_SLOAD;
    const bool table_op = st_op || op == OP_TSTORE || op == OP_TLOAD;
    const bool table_write = op == OP_SSTORE || op == OP_TSTORE;
    const int n_slots = st_op ? K : T;
    const long long row = L * n_slots;
    int32_t* keys = arg_ptr<int32_t>(a, st_op ? L_STORAGE_KEYS : L_TSTORE_KEYS) + row * 16;
    int32_t* vals = arg_ptr<int32_t>(a, st_op ? L_STORAGE_VALS : L_TSTORE_VALS) + row * 16;
    uint8_t* used = arg_ptr<uint8_t>(a, st_op ? L_STORAGE_USED : L_TSTORE_USED) + row;
    if (table_op) {
        int match = NO_SLOT, free_slot = NO_SLOT;
        for (int s = t; s < n_slots; s += STEP_THREADS) {
            if (!used[s]) {
                free_slot = free_slot < s ? free_slot : s;
                continue;
            }
            bool same = true;
            for (int i = 0; i < 16; ++i) same = same && keys[16 * s + i] == sh.in16[0][i];
            if (!same) continue;
            match = match < s ? match : s;
            if (!table_write)  // SLOAD/TLOAD: the sum of every match
                for (int i = 0; i < 16; ++i)
                    atomicAdd(&sh.res[i], static_cast<uint32_t>(vals[16 * s + i]));
        }
        if (table_write) {
            if (match != NO_SLOT) atomicMin(&sh.first_match, match);
            if (free_slot != NO_SLOT) atomicMin(&sh.first_free, free_slot);
        }
    }
    const bool byte_result = op == OP_MLOAD || op == OP_CALLDATALOAD || op == OP_SHA3
                             || (is_push && op != 0x5F);
    if (byte_result) {
        const long long j = t;
        uint8_t byte = 0;
        if (op == OP_MLOAD) {
            byte = mem_byte(off_i + j, new_msize);
        } else if (op == OP_CALLDATALOAD) {
            bool fits;
            const long long base = w_low32(wa, &fits);
            const long long cd_len = arg_ptr<int32_t>(a, L_CALLDATA_LEN)[lane];
            if (fits && base + j < cd_len)
                byte = arg_ptr<uint8_t>(a, L_CALLDATA)[L * D + base + j];
        } else if (op == OP_SHA3) {
            byte = arg_ptr<uint8_t>(a, K2_DIGEST)[L * 32 + j];
        }
        // PUSHn: immediate byte k = j - (32 - n) is the prefetched code byte
        // of thread k, which reads 0 past code_len
        sh.bytes[j] = byte;
        if (is_push) sh.bytes[32 + j] = code_byte;
    }
    uint32_t limb = 0;  // a DUP's or an env word's limb t
    int env_field = -1;
    switch (op) {
        case OP_ADDRESS: env_field = L_ADDRESS; break;
        case OP_ORIGIN: env_field = L_ORIGIN; break;
        case OP_CALLER: env_field = L_CALLER; break;
        case OP_CALLVALUE: env_field = L_CALLVALUE; break;
        case OP_GASPRICE: env_field = L_GASPRICE; break;
        case OP_COINBASE: env_field = L_COINBASE; break;
        case OP_TIMESTAMP: env_field = L_TIMESTAMP; break;
        case OP_NUMBER: env_field = L_NUMBER; break;
        case OP_PREVRANDAO: env_field = L_PREVRANDAO; break;
        case OP_GASLIMIT: env_field = L_BLOCK_GASLIMIT; break;
        case OP_CHAINID: env_field = L_CHAINID; break;
        case OP_SELFBALANCE: env_field = L_SELFBALANCE; break;
        case OP_BASEFEE: env_field = L_BASEFEE; break;
        default: break;
    }
    if (t < 16 && env_field >= 0)
        limb = static_cast<uint32_t>(arg_ptr<int32_t>(a, env_field)[L * 16 + t]);
    if (t < 16 && is_dup)
        limb = static_cast<uint32_t>(slot_ptr(a, lane, sp, op - 0x7F)[t]);
    if (is_heavy(op) && t == 0)
        heavy_word(op, sh.in16[0], sh.in16[1], sh.in16[2], sh.res);
    bool src_fits;
    const long long src = w_low32(wb, &src_fits);
    if (op == OP_MCOPY && copy_mask && !copy_escape)
        // the source as it stood: bytes at or past the old msize read 0
        for (long long j = t; j < copy_len; j += STEP_THREADS)
            sh.bytes[j] = mem_byte(src + j, msize);
    __syncthreads();

    // ---- status resolution (errors > escapes > halts) ---------------------------
    // SSTORE / TSTORE: first matching slot, else first free slot
    int tab_slot = -1;
    if (table_write)
        tab_slot = sh.first_match != NO_SLOT ? sh.first_match
                   : (sh.first_free != NO_SLOT ? sh.first_free : -1);
    const bool tab_full = table_write && tab_slot < 0;
    const bool bad_jump = jumping && !dest_ok;
    if (jumping && dest_ok) next_pc = jump_dest;
    const bool is_error = invalid || underflow || overflow_evm || oog || mem_oog
                          || bad_jump || op == OP_INVALID;
    const bool wants_escape = escape_op || overflow_cap || mem_escape
                              || sha_escape || copy_escape || ret_escape
                              || tab_full;
    if (is_error || wants_escape) {
        if (t == 0) *status_p = is_error ? ST_ERRORED : ST_ESCAPED;
        return;  // the whole block
    }
    int new_status = ST_RUNNING;
    if (op == OP_STOP) new_status = ST_STOPPED;
    else if (ret_do && op == OP_RETURN) new_status = ST_RETURNED;
    else if (ret_do && op == OP_REVERT) new_status = ST_REVERTED;

    // ---- the result word, a limb a thread, and the stack ----------------------------
    int32_t* stack = arg_ptr<int32_t>(a, L_STACK) + L * S * 16;
    if (t < 16) {
        const int i = t;
        uint32_t r = 0;
        if (is_push && op != 0x5F) {
            // big-endian byte k of the word is code byte k - (32 - n)
            auto imm = [&](int k) -> uint32_t {
                const int at = k - (32 - imm_len);
                return at >= 0 ? sh.bytes[32 + at] : 0;
            };
            r = imm(31 - 2 * i) | (imm(30 - 2 * i) << 8);
        } else if (byte_result) {
            r = be_limb16(sh.bytes, i);
        } else if (is_heavy(op) || op == OP_SLOAD || op == OP_TLOAD) {
            r = sh.res[i];
        } else if (is_dup || env_field >= 0) {
            r = limb;
        } else {
            const uint32_t x = static_cast<uint32_t>(sh.in16[0][i]);
            const uint32_t y = static_cast<uint32_t>(sh.in16[1][i]);
            auto flag = [&](bool value) { return i == 0 ? static_cast<uint32_t>(value) : 0u; };
            switch (op) {
                case OP_ADD: r = w_limb16(w_add(wa, wb), i); break;
                case OP_SUB: r = w_limb16(w_sub(wa, wb), i); break;
                case OP_MUL: r = w_limb16(w_mul(wa, wb), i); break;
                case OP_LT: r = flag(w_lt(wa, wb)); break;
                case OP_GT: r = flag(w_lt(wb, wa)); break;
                case OP_SLT: r = flag(w_slt(wa, wb)); break;
                case OP_SGT: r = flag(w_slt(wb, wa)); break;
                case OP_EQ: r = flag(w_eq(wa, wb)); break;
                case OP_ISZERO: r = flag(w_is_zero(wa)); break;
                case OP_AND: r = x & y; break;
                case OP_OR: r = x | y; break;
                case OP_XOR: r = x ^ y; break;
                case OP_NOT: r = x ^ 0xFFFFu; break;
                case OP_BYTE: r = w_limb16(w_byte(wa, wb), i); break;
                case OP_SHL: r = w_limb16(w_shl(w_small(wa, 256), wb), i); break;
                case OP_SHR: r = w_limb16(w_shr(w_small(wa, 256), wb), i); break;
                case OP_SAR: r = w_limb16(w_sar(w_small(wa, 256), wb), i); break;
                case OP_CALLDATASIZE:
                    r = w_limb16(w_u64(static_cast<uint32_t>(
                                     arg_ptr<int32_t>(a, L_CALLDATA_LEN)[lane])), i);
                    break;
                case OP_CODESIZE: r = w_limb16(w_u64(static_cast<uint64_t>(code_len)), i); break;
                case OP_RETURNDATASIZE:
                    r = w_limb16(w_u64(static_cast<uint32_t>(
                                     arg_ptr<int32_t>(a, L_RETDATA_LEN)[lane])), i);
                    break;
                case OP_PC: r = w_limb16(w_u64(static_cast<uint64_t>(pc)), i); break;
                case OP_MSIZE: r = w_limb16(w_u64(static_cast<uint64_t>(new_msize)), i); break;
                case OP_GAS: {
                    const long long left = gas_limit - new_gas;
                    r = w_limb16(w_u64(static_cast<uint64_t>(left > 0 ? left : 0)), i);
                    break;
                }
                default: break;
            }
        }
        // each thread reads and writes only its own limb of every slot
        if (pushes >= 1 && !is_swap)
            stack[16 * clampll(new_sp - 1, 0, S - 1) + i] = static_cast<int32_t>(r);
        if (is_swap) {
            int32_t* top = stack + 16 * clampll(sp - 1, 0, S - 1);
            int32_t* deep = stack + 16 * clampll(sp - 1 - (op - 0x8F), 0, S - 1);
            const int32_t x = top[i];
            top[i] = deep[i];
            deep[i] = x;
        }
        if (table_write) {
            keys[16 * tab_slot + i] = sh.in16[0][i];
            vals[16 * tab_slot + i] = sh.in16[1][i];
        }
    }

    // ---- memory, return data, scalars -------------------------------------------
    if (op == OP_MSTORE && mem_ok && off_i + t < M)
        memory[off_i + t] = limbs16_be_byte(reinterpret_cast<const uint32_t*>(sh.in16[1]), t);
    if (op == OP_MSTORE8 && mem_ok && off_i < M && t == 0)
        memory[off_i] = static_cast<uint8_t>(sh.in16[1][0] & 0xFF);
    if (copy_mask && copy_len > 0) {
        bool dst_fits;
        const long long dst = op == OP_MCOPY ? w_low32(wa, &dst_fits) : off_i;
        const uint8_t* buf = nullptr;
        long long buf_len = 0, cap = 0;
        if (op == OP_CALLDATACOPY) {
            buf = arg_ptr<uint8_t>(a, L_CALLDATA) + L * D;
            buf_len = arg_ptr<int32_t>(a, L_CALLDATA_LEN)[lane];
            cap = D;
        } else if (op == OP_CODECOPY) {
            buf = code;
            buf_len = code_len;
            cap = C;
        } else if (op == OP_RETURNDATACOPY) {
            buf = arg_ptr<uint8_t>(a, L_RETDATA) + L * R;
            buf_len = arg_ptr<int32_t>(a, L_RETDATA_LEN)[lane];
            cap = R;
        }
        for (long long j = t; j < copy_len; j += STEP_THREADS) {
            const long long s = src + j, d = dst + j;
            if (d < 0 || d >= M) continue;
            memory[d] = buf ? ((src_fits && s < buf_len) ? buf[clampll(s, 0, cap - 1)] : 0)
                            : sh.bytes[j];
        }
    }
    if (ret_do) {
        uint8_t* ret = arg_ptr<uint8_t>(a, L_RETDATA) + L * R;
        for (long long j = t; j < ret_len; j += STEP_THREADS)
            ret[j] = mem_byte(off_i + j, new_msize);
        if (t == 0) arg_ptr<int32_t>(a, L_RETDATA_LEN)[lane] = static_cast<int32_t>(ret_len);
    }
    if (t == 0) {
        if (table_write) used[tab_slot] = 1;
        arg_ptr<int32_t>(a, L_SP)[lane] = static_cast<int32_t>(new_sp);
        arg_ptr<int32_t>(a, L_PC)[lane] = static_cast<int32_t>(next_pc);
        arg_ptr<long long>(a, L_GAS_USED)[lane] = new_gas;
        arg_ptr<int32_t>(a, L_MSIZE)[lane] = static_cast<int32_t>(new_msize);
        *status_p = new_status;
    }
}

// blocks and threads of the last evm_step launch (mtpu_evm_step_grid)
static int g_step_grid[2];

MTPU_EXPORT int mtpu_evm_step(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const int batch = static_cast<int>(a.v[K2_B]);
    if (batch <= 0) return 0;
    g_step_grid[0] = batch;
    g_step_grid[1] = STEP_THREADS;
    MTPU_LAUNCH(evm_step_kernel, g_step_grid[0], g_step_grid[1], stream, a);
    return MTPU_LAUNCH_STATUS();
}

// out[0], out[1] = the grid and block size the last evm_step launch used
MTPU_EXPORT int mtpu_evm_step_grid(long long* out, int n, void*) {
    for (int i = 0; i < n && i < 2; ++i) out[i] = g_step_grid[i];
    return 0;
}

// load this source's kernels (before a CUDA graph captures them)
MTPU_EXPORT int mtpu_evm_preload(const long long*, int, void*) {
    return MTPU_PRELOAD(evm_step_kernel);
}
