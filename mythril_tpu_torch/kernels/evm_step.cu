// Kernel K2: one concrete EVM instruction for every lane.
//
// Replaces mythril_tpu/parallel/lockstep.py:159 `step` (with `step_many`,
// 617, and `run`, 623) and everything of words.py it inlines. The TPU
// program evaluates every opcode family for every lane as masked vector
// ops; here one thread owns one lane and evaluates only its own opcode,
// which is the SIMT form of the same masked evaluation. Results are the
// JAX step's bit for bit: the lower-bound gas model, EVM word semantics
// (words.cuh), bytes at or beyond msize reading 0, table inserts into the
// first matching or free slot, masked and out-of-capacity writes dropped,
// and lanes forced out by the symbolic pre-pass frozen. The state is
// updated in place: a lane commits only when it neither errs nor escapes.
//
// Two launches per step: `sha_prep` finds the SHA3 lanes and their memory
// ranges for kernel K1 (keccak.cu), which hashes them before `evm_step`
// runs. Bound: operations for the lanes that divide, multiply or hash;
// otherwise the bytes of the few rows a lane touches (one thread per lane
// reads its own stack slots, memory range and tables).
#include "words.cuh"

namespace {

__device__ __forceinline__ int op_at(const Args& a, int lane, int pc) {
    const int C = arg_int(a, K2_C);
    if (pc >= arg_ptr<int32_t>(a, L_CODE_LEN)[lane]) return OP_STOP;
    int idx = pc < 0 ? 0 : (pc > C - 1 ? C - 1 : pc);
    return arg_ptr<uint8_t>(a, L_CODE)[static_cast<long long>(lane) * C + idx];
}

__device__ __forceinline__ bool running_of(const Args& a, int lane) {
    bool running = arg_ptr<int32_t>(a, L_STATUS)[lane] == ST_RUNNING;
    const uint8_t* fe = arg_ptr<const uint8_t>(a, K2_FORCE_ESCAPE);
    const uint8_t* ff = arg_ptr<const uint8_t>(a, K2_FORCE_FORK);
    if (fe) running = running && !fe[lane] && !ff[lane];
    return running;
}

__device__ __forceinline__ const int32_t* slot_ptr(const Args& a, int lane,
                                                   long long sp, int n) {
    const int S = arg_int(a, K2_S);
    long long idx = sp - n;
    idx = idx < 0 ? 0 : (idx > S - 1 ? S - 1 : idx);
    return arg_ptr<int32_t>(a, L_STACK) + (static_cast<long long>(lane) * S + idx) * 16;
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

// SHA3 lanes: memory offset, clipped length and whether to hash
__global__ void sha_prep_kernel(Args a) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= arg_int(a, K2_B)) return;
    bool hash = false;
    long long off = 0;
    int len = 0;
    if (running_of(a, lane)) {
        const int sp = arg_ptr<int32_t>(a, L_SP)[lane];
        const int op = op_at(a, lane, arg_ptr<int32_t>(a, L_PC)[lane]);
        if (op == OP_SHA3) {
            bool off_fits, len_fits;
            off = w_low32(w_load16(slot_ptr(a, lane, sp, 1)), &off_fits);
            long long n = w_low32(w_load16(slot_ptr(a, lane, sp, 2)), &len_fits);
            hash = len_fits && n <= 512;
            len = static_cast<int>(clampll(n, 0, 512));
        }
    }
    arg_ptr<long long>(a, K2_SHA_OFF)[lane] = off;
    arg_ptr<int32_t>(a, K2_SHA_LEN)[lane] = len;
    arg_ptr<uint8_t>(a, K2_SHA_MASK)[lane] = hash;
}

__global__ void evm_step_kernel(Args a) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= arg_int(a, K2_B)) return;
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
        if (fe && status == ST_RUNNING)
            *status_p = ff[lane] ? ST_FORKING : (fe[lane] ? ST_ESCAPED : status);
        return;
    }

    const int32_t* optab = arg_ptr<const int32_t>(a, K2_OPTAB);
    const long long pc = arg_ptr<int32_t>(a, L_PC)[lane];
    const long long sp = arg_ptr<int32_t>(a, L_SP)[lane];
    const long long msize = arg_ptr<int32_t>(a, L_MSIZE)[lane];
    const long long code_len = arg_ptr<int32_t>(a, L_CODE_LEN)[lane];
    const int op = op_at(a, lane, static_cast<int>(pc));
    const int pops = optab[4 * op + OPT_POPS];
    const int pushes = optab[4 * op + OPT_PUSHES];
    const int flags = optab[4 * op + OPT_FLAGS];

    // ---- validity / stack preflight ---------------------------------------------
    const bool invalid = !(flags & OPF_VALID);
    const bool underflow = sp < pops;
    const long long new_sp = sp - pops + pushes;
    const bool overflow_cap = new_sp > S;
    const bool overflow_evm = new_sp > 1024;
    const bool escape_op = flags & OPF_ESCAPE;

    const int32_t* a_p = slot_ptr(a, lane, sp, 1);
    const int32_t* b_p = slot_ptr(a, lane, sp, 2);
    const W wa = w_load16(a_p), wb = w_load16(b_p),
            wc = w_load16(slot_ptr(a, lane, sp, 3));

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

    const uint8_t* memory = arg_ptr<uint8_t>(a, L_MEMORY) + L * M;
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

    // ---- result ------------------------------------------------------------------
    // held as 16 limbs of 16 bits: table reads and env words are copied
    // limb for limb as the JAX select does
    uint32_t res[16];
    for (int i = 0; i < 16; ++i) res[i] = 0;
    auto set_w = [&](const W& w) { w_to16(w, res); };
    auto copy_limbs = [&](const int32_t* p) {
        for (int i = 0; i < 16; ++i) res[i] = static_cast<uint32_t>(p[i]);
    };
    auto env_word = [&](int field) {
        copy_limbs(arg_ptr<int32_t>(a, field) + L * 16);
    };
    auto table_read = [&](int keys_f, int vals_f, int used_f, int n) {
        const int32_t* keys = arg_ptr<int32_t>(a, keys_f) + L * n * 16;
        const int32_t* vals = arg_ptr<int32_t>(a, vals_f) + L * n * 16;
        const uint8_t* used = arg_ptr<uint8_t>(a, used_f) + L * n;
        for (int s = 0; s < n; ++s) {
            if (!used[s]) continue;
            bool match = true;
            for (int i = 0; i < 16; ++i) match = match && keys[16 * s + i] == a_p[i];
            if (match)
                for (int i = 0; i < 16; ++i)
                    res[i] += static_cast<uint32_t>(vals[16 * s + i]);
        }
    };
    const bool is_push = op >= 0x5F && op <= 0x7F;
    const bool is_dup = op >= 0x80 && op <= 0x8F;
    const bool is_swap = op >= 0x90 && op <= 0x9F;
    const int imm_len = is_push ? op - 0x5F : 0;

    switch (op) {
        case OP_ADD: set_w(w_add(wa, wb)); break;
        case OP_SUB: set_w(w_sub(wa, wb)); break;
        case OP_MUL: set_w(w_mul(wa, wb)); break;
        case OP_DIV: case OP_SDIV: case OP_MOD: case OP_SMOD:
            set_w(w_div_family(op, wa, wb)); break;
        case OP_ADDMOD: set_w(w_addmod(wa, wb, wc)); break;
        case OP_MULMOD: set_w(w_mulmod(wa, wb, wc)); break;
        case OP_EXP: set_w(w_exp(wa, wb)); break;
        case OP_SIGNEXTEND: set_w(w_signextend(wa, wb)); break;
        case OP_LT: res[0] = w_lt(wa, wb); break;
        case OP_GT: res[0] = w_lt(wb, wa); break;
        case OP_SLT: res[0] = w_slt(wa, wb); break;
        case OP_SGT: res[0] = w_slt(wb, wa); break;
        case OP_EQ: res[0] = w_eq(wa, wb); break;
        case OP_ISZERO: res[0] = w_is_zero(wa); break;
        case OP_AND: for (int i = 0; i < 16; ++i) res[i] = a_p[i] & b_p[i]; break;
        case OP_OR: for (int i = 0; i < 16; ++i) res[i] = a_p[i] | b_p[i]; break;
        case OP_XOR: for (int i = 0; i < 16; ++i) res[i] = a_p[i] ^ b_p[i]; break;
        case OP_NOT:
            for (int i = 0; i < 16; ++i) res[i] = static_cast<uint32_t>(a_p[i]) ^ 0xFFFFu;
            break;
        case OP_BYTE: set_w(w_byte(wa, wb)); break;
        case OP_SHL: set_w(w_shl(w_small(wa, 256), wb)); break;
        case OP_SHR: set_w(w_shr(w_small(wa, 256), wb)); break;
        case OP_SAR: set_w(w_sar(w_small(wa, 256), wb)); break;
        case OP_SHA3:
            set_w(w_from_be(arg_ptr<uint8_t>(a, K2_DIGEST) + L * 32)); break;
        case OP_ADDRESS: env_word(L_ADDRESS); break;
        case OP_ORIGIN: env_word(L_ORIGIN); break;
        case OP_CALLER: env_word(L_CALLER); break;
        case OP_CALLVALUE: env_word(L_CALLVALUE); break;
        case OP_CALLDATALOAD: {
            bool fits;
            long long base = w_low32(wa, &fits);
            const long long cd_len = arg_ptr<int32_t>(a, L_CALLDATA_LEN)[lane];
            const uint8_t* cd = arg_ptr<uint8_t>(a, L_CALLDATA) + L * D;
            uint8_t bytes[32];
            for (int j = 0; j < 32; ++j)
                bytes[j] = (fits && base + j < cd_len) ? cd[base + j] : 0;
            set_w(w_from_be(bytes));
            break;
        }
        case OP_CALLDATASIZE:
            set_w(w_u64(static_cast<uint32_t>(arg_ptr<int32_t>(a, L_CALLDATA_LEN)[lane])));
            break;
        case OP_CODESIZE: set_w(w_u64(static_cast<uint64_t>(code_len))); break;
        case OP_GASPRICE: env_word(L_GASPRICE); break;
        case OP_RETURNDATASIZE:
            set_w(w_u64(static_cast<uint32_t>(arg_ptr<int32_t>(a, L_RETDATA_LEN)[lane])));
            break;
        case OP_COINBASE: env_word(L_COINBASE); break;
        case OP_TIMESTAMP: env_word(L_TIMESTAMP); break;
        case OP_NUMBER: env_word(L_NUMBER); break;
        case OP_PREVRANDAO: env_word(L_PREVRANDAO); break;
        case OP_GASLIMIT: env_word(L_BLOCK_GASLIMIT); break;
        case OP_CHAINID: env_word(L_CHAINID); break;
        case OP_SELFBALANCE: env_word(L_SELFBALANCE); break;
        case OP_BASEFEE: env_word(L_BASEFEE); break;
        case OP_PC: set_w(w_u64(static_cast<uint64_t>(pc))); break;
        case OP_MSIZE: set_w(w_u64(static_cast<uint64_t>(new_msize))); break;
        case OP_GAS: {
            long long left = gas_limit - new_gas;
            set_w(w_u64(static_cast<uint64_t>(left > 0 ? left : 0)));
            break;
        }
        case OP_MLOAD: {
            uint8_t bytes[32];
            for (int j = 0; j < 32; ++j) bytes[j] = mem_byte(off_i + j, new_msize);
            set_w(w_from_be(bytes));
            break;
        }
        case OP_SLOAD:
            table_read(L_STORAGE_KEYS, L_STORAGE_VALS, L_STORAGE_USED, K); break;
        case OP_TLOAD:
            table_read(L_TSTORE_KEYS, L_TSTORE_VALS, L_TSTORE_USED, T); break;
        default:
            if (is_push) {
                const uint8_t* code = arg_ptr<uint8_t>(a, L_CODE) + L * C;
                uint8_t bytes[32];
                for (int j = 0; j < 32; ++j) {
                    long long src = pc + 1 + j - (32 - imm_len);
                    bytes[j] = (src >= pc + 1 && src < code_len)
                        ? code[clampll(src, 0, C - 1)] : 0;
                }
                set_w(w_from_be(bytes));
            } else if (is_dup) {
                copy_limbs(slot_ptr(a, lane, sp, op - 0x7F));
            }
            break;
    }

    // ---- copies, returns, tables: decide escapes before committing ----------
    const bool mem_ok = !mem_oog && !mem_escape;
    const bool copy_mask = is_copy && mem_ok;
    const long long copy_len = copy_mask ? size_i : 0;
    const bool copy_escape = copy_mask && copy_len > 512;
    const bool ret_mask = (op == OP_RETURN || op == OP_REVERT) && mem_ok;
    const long long ret_len = ret_mask ? size_i : 0;
    const bool ret_escape = ret_mask && ret_len > R;
    const bool ret_do = ret_mask && !ret_escape;

    // SSTORE / TSTORE: first matching slot, else first free slot
    int tab_slot = -1;
    bool tab_full = false;
    if (op == OP_SSTORE || op == OP_TSTORE) {
        const bool st = op == OP_SSTORE;
        const int n = st ? K : T;
        const int32_t* keys = arg_ptr<int32_t>(a, st ? L_STORAGE_KEYS : L_TSTORE_KEYS) + L * n * 16;
        const uint8_t* used = arg_ptr<uint8_t>(a, st ? L_STORAGE_USED : L_TSTORE_USED) + L * n;
        int free_slot = -1;
        for (int s = 0; s < n; ++s) {
            if (!used[s]) {
                if (free_slot < 0) free_slot = s;
                continue;
            }
            bool match = true;
            for (int i = 0; i < 16; ++i) match = match && keys[16 * s + i] == a_p[i];
            if (match) { tab_slot = s; break; }
        }
        if (tab_slot < 0) {
            tab_slot = free_slot;
            tab_full = free_slot < 0;
        }
    }

    // ---- control flow ------------------------------------------------------------
    long long next_pc = pc + 1 + imm_len;
    bool jump_fits;
    const long long jump_dest_i = w_low32(wa, &jump_fits);
    const long long jump_dest = clampll(jump_dest_i, 0, C - 1);
    const bool dest_ok = jump_fits && jump_dest_i < code_len
        && arg_ptr<uint8_t>(a, L_JUMPDEST)[L * C + jump_dest];
    const bool jumping = op == OP_JUMP || (op == OP_JUMPI && !w_is_zero(wb));
    const bool bad_jump = jumping && !dest_ok;
    if (jumping && dest_ok) next_pc = jump_dest;

    // ---- status resolution (errors > escapes > halts) ---------------------------
    const bool is_error = invalid || underflow || overflow_evm || oog || mem_oog
                          || bad_jump || op == OP_INVALID;
    const bool wants_escape = escape_op || overflow_cap || mem_escape
                              || sha_escape || copy_escape || ret_escape
                              || tab_full;
    if (is_error) { *status_p = ST_ERRORED; return; }
    if (wants_escape) { *status_p = ST_ESCAPED; return; }
    int new_status = ST_RUNNING;
    if (op == OP_STOP) new_status = ST_STOPPED;
    else if (ret_do && op == OP_RETURN) new_status = ST_RETURNED;
    else if (ret_do && op == OP_REVERT) new_status = ST_REVERTED;

    // ---- commit ------------------------------------------------------------------
    int32_t* stack = arg_ptr<int32_t>(a, L_STACK) + L * S * 16;
    const bool writes_result = pushes >= 1 && !is_swap;
    if (writes_result) {
        int32_t* top = stack + 16 * clampll(new_sp - 1, 0, S - 1);
        for (int i = 0; i < 16; ++i) top[i] = static_cast<int32_t>(res[i]);
    }
    if (is_swap) {
        int32_t* top = stack + 16 * clampll(sp - 1, 0, S - 1);
        int32_t* deep = stack + 16 * clampll(sp - 1 - (op - 0x8F), 0, S - 1);
        for (int i = 0; i < 16; ++i) {
            int32_t t = top[i];
            top[i] = deep[i];
            deep[i] = t;
        }
    }

    uint8_t* mem_w = arg_ptr<uint8_t>(a, L_MEMORY) + L * M;
    if (op == OP_MSTORE && mem_ok) {
        uint32_t limbs[16];
        for (int i = 0; i < 16; ++i) limbs[i] = static_cast<uint32_t>(b_p[i]);
        for (int j = 0; j < 32; ++j)
            if (off_i + j < M) mem_w[off_i + j] = limbs16_be_byte(limbs, j);
    }
    if (op == OP_MSTORE8 && mem_ok && off_i < M)
        mem_w[off_i] = static_cast<uint8_t>(b_p[0] & 0xFF);
    if (copy_mask && copy_len > 0) {
        bool src_fits, dst_fits;
        const long long src = w_low32(wb, &src_fits);
        const long long dst = op == OP_MCOPY ? w_low32(wa, &dst_fits) : off_i;
        const uint8_t* buf = nullptr;
        long long buf_len = 0, cap = 0;
        if (op == OP_CALLDATACOPY) {
            buf = arg_ptr<uint8_t>(a, L_CALLDATA) + L * D;
            buf_len = arg_ptr<int32_t>(a, L_CALLDATA_LEN)[lane];
            cap = D;
        } else if (op == OP_CODECOPY) {
            buf = arg_ptr<uint8_t>(a, L_CODE) + L * C;
            buf_len = code_len;
            cap = C;
        } else if (op == OP_RETURNDATACOPY) {
            buf = arg_ptr<uint8_t>(a, L_RETDATA) + L * R;
            buf_len = arg_ptr<int32_t>(a, L_RETDATA_LEN)[lane];
            cap = R;
        }
        if (buf) {
            for (long long j = 0; j < copy_len; ++j) {
                long long s = src + j, d = dst + j;
                if (d < 0 || d >= M) continue;
                mem_w[d] = (src_fits && s < buf_len) ? buf[clampll(s, 0, cap - 1)] : 0;
            }
        } else {
            // MCOPY reads the memory as it stood (bytes >= msize read 0):
            // copy in the direction that never reads a byte already written
            const bool backward = dst > src;
            for (long long k = 0; k < copy_len; ++k) {
                long long j = backward ? copy_len - 1 - k : k;
                long long s = src + j, d = dst + j;
                if (d < 0 || d >= M) continue;
                mem_w[d] = (s >= 0 && s < msize) ? mem_w[s] : 0;
            }
        }
    }
    if (ret_do) {
        uint8_t* ret = arg_ptr<uint8_t>(a, L_RETDATA) + L * R;
        for (long long j = 0; j < ret_len; ++j) ret[j] = mem_byte(off_i + j, new_msize);
        arg_ptr<int32_t>(a, L_RETDATA_LEN)[lane] = static_cast<int32_t>(ret_len);
    }
    if ((op == OP_SSTORE || op == OP_TSTORE) && tab_slot >= 0) {
        const bool st = op == OP_SSTORE;
        const int n = st ? K : T;
        int32_t* keys = arg_ptr<int32_t>(a, st ? L_STORAGE_KEYS : L_TSTORE_KEYS) + (L * n + tab_slot) * 16;
        int32_t* vals = arg_ptr<int32_t>(a, st ? L_STORAGE_VALS : L_TSTORE_VALS) + (L * n + tab_slot) * 16;
        for (int i = 0; i < 16; ++i) { keys[i] = a_p[i]; vals[i] = b_p[i]; }
        arg_ptr<uint8_t>(a, st ? L_STORAGE_USED : L_TSTORE_USED)[L * n + tab_slot] = 1;
    }
    arg_ptr<int32_t>(a, L_SP)[lane] = static_cast<int32_t>(new_sp);
    arg_ptr<int32_t>(a, L_PC)[lane] = static_cast<int32_t>(next_pc);
    arg_ptr<long long>(a, L_GAS_USED)[lane] = new_gas;
    arg_ptr<int32_t>(a, L_MSIZE)[lane] = static_cast<int32_t>(new_msize);
    *status_p = new_status;
}

MTPU_EXPORT int mtpu_sha_prep(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const int batch = static_cast<int>(a.v[K2_B]);
    if (batch <= 0) return 0;
    MTPU_LAUNCH(sha_prep_kernel, (batch + 127) / 128, 128, stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_evm_step(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const int batch = static_cast<int>(a.v[K2_B]);
    if (batch <= 0) return 0;
    MTPU_LAUNCH(evm_step_kernel, (batch + 127) / 128, 128, stream, a);
    return MTPU_LAUNCH_STATUS();
}

// load this source's kernels (before a CUDA graph captures them)
MTPU_EXPORT int mtpu_evm_preload(const long long*, int, void*) {
    return MTPU_PRELOAD(sha_prep_kernel) | MTPU_PRELOAD(evm_step_kernel);
}
