// Kernel K4: the symbolic frontier step around kernels K2 and K3.
//
// Replaces mythril_tpu/parallel/symstep.py:347 `sym_step` as fused by
// `run_chunk` (961), `sym_step_many` (974) and `sym_step_many_counted`
// (990), for the single-shard scheduler. One step is four launches of this
// source around the concrete step (K2) and the four arena allocations (K3):
//
//   sym_pre   free ERRORED lanes; reseed DEAD lanes from the DFS stack by
//             rank (symstep.py:364-391); fetch and classify every lane as
//             FORK / cold-SLOAD pause / ESCAPE (464-537) into scratch rows
//   sym_mid1  after K2: which lanes want CONST, result and env-VAR nodes
//   sym_mid2  after the two CONST allocations: the operand node ids
//   sym_post  mirror the stack, memory and storage planes (583-653 and
//             `_sym_stack_update`, 913); move escaped rows into the escape
//             buffer by rank (655-681); fork symbolic JUMPIs: claim a DEAD
//             lane, push onto the stack or spill into the escape buffer,
//             all by rank (683-820)
//
// Each launch is one block with a thread per lane (B <= 1024): every rank is
// a block-wide exclusive scan, never an atomic, so lane placement and pool
// rows equal the JAX package's. Row moves copy all 46 leaves of a lane row
// (about 39 KB at the frontier's default geometry) with the whole block.
// Everything is updated in place. Bound: bytes (the moved rows and the
// planes each lane touches); a single block leaves most of the card idle,
// which is the simple form this slice ships.
//
// Kernel K9, the telemetry plane (symstep.py:822-908 with 359-360), is the
// `TEL = true` instantiation of sym_pre and sym_post: no launch of its own,
// and the `TEL = false` program is the plane-free step, unchanged. sym_pre
// counts the ERRORED lanes before freeing them, the reseeds and the running
// lanes, and leaves each escaping lane's cause (most specific wins) and each
// running lane's fleet slot in scratch rows: both read the lane's pre-step
// planes, which K2 and sym_post then update in place. sym_post counts op
// classes, causes, the post-step lifecycle transitions, tag and fleet
// occupancy into shared-memory integer counters (atomic adds: sums commute,
// so the counts are exact and ordered as JAX's) and adds them to the plane;
// the high-water marks read the step's final pool tops.
#include "common.cuh"

namespace {

enum { VAR_TAG = 0x101, V_CALLDATA_WORD = 1 };

// escape causes (symstep.ESC_CAUSE_NAMES) and lifecycle counters
// (symstep.LIFECYCLE_NAMES) by index
enum { EC_HALT = 0, EC_SYM_JUMP_DEST = 1, EC_DETECTOR_BRANCH = 2,
       EC_SYM_MEM_OFF = 3, EC_DIRTY_MLOAD = 4, EC_SYM_STORAGE_KEY = 5,
       EC_SYM_MEM_REGION = 6, EC_HOST_OP = 7 };
enum { LC_RESEEDS = 0, LC_ERR_DEATHS = 1, LC_OVERFLOW_KILLS = 2,
       LC_BAD_JUMP_DEATHS = 3, LC_ESC_BUFFERED = 4, LC_ESC_FROZEN = 5,
       LC_FORK_WAITS = 6, LC_COLD_SLOADS = 7, LC_FORKS_CLAIMED = 8,
       LC_FORKS_PUSHED = 9, LC_FORKS_SPILLED = 10, LC_FROZEN_REVIVED = 11 };

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

template <class T>
__device__ __forceinline__ T* leaf(const Args& a, int base, int field) {
    return arg_ptr<T>(a, base + field);
}

__device__ __forceinline__ int32_t* iscr(const Args& a, int row) {
    return arg_ptr<int32_t>(a, K4_ISCR) + static_cast<long long>(row) * arg_int(a, K4_B);
}

__device__ __forceinline__ uint8_t* fscr(const Args& a, int row) {
    return arg_ptr<uint8_t>(a, K4_FSCR) + static_cast<long long>(row) * arg_int(a, K4_B);
}

__device__ __forceinline__ int32_t* wscr(const Args& a, int row, int lane) {
    return arg_ptr<int32_t>(a, K4_WSCR)
           + (static_cast<long long>(row) * arg_int(a, K4_B) + lane) * 16;
}

// low 32 bits of 16 stored limbs and whether no higher bit is set
__device__ __forceinline__ long long low32(const int32_t* w, bool* fits) {
    bool f = true;
    for (int i = 2; i < 16; ++i) f = f && w[i] == 0;
    *fits = f;
    return static_cast<long long>((static_cast<uint32_t>(w[0]) & 0xFFFFu)
                                  | ((static_cast<uint32_t>(w[1]) & 0xFFFFu) << 16));
}

// first used slot of a [n,16] key table equal to `key` (-1 if none)
__device__ __forceinline__ int table_find(const int32_t* keys,
                                          const uint8_t* used, int n,
                                          const int32_t* key) {
    for (int s = 0; s < n; ++s) {
        if (!used[s]) continue;
        bool match = true;
        for (int i = 0; i < 16; ++i) match = match && keys[16 * s + i] == key[i];
        if (match) return s;
    }
    return -1;
}

// every leaf of row `src_row` of row set `src_base` into row `dst_row` of
// `dst_base`; all threads of the block take part
__device__ void copy_row(const Args& a, int src_base, long long src_row,
                         int dst_base, long long dst_row) {
    for (int f = 0; f < N_ROW_LEAVES; ++f) {
        const long long rb = a.v[K4_ROW_BYTES + f];
        const char* s = arg_ptr<const char>(a, src_base + f) + src_row * rb;
        char* d = arg_ptr<char>(a, dst_base + f) + dst_row * rb;
        if (rb % 4 == 0) {
            const int32_t* s4 = reinterpret_cast<const int32_t*>(s);
            int32_t* d4 = reinterpret_cast<int32_t*>(d);
            for (long long i = threadIdx.x; i < rb / 4; i += blockDim.x) d4[i] = s4[i];
        } else {
            for (long long i = threadIdx.x; i < rb; i += blockDim.x) d[i] = s[i];
        }
    }
}

}  // namespace

template <bool TEL>
__global__ void sym_pre_kernel(Args a) {
    __shared__ int buf[1024];
    __shared__ int mv_src[1024], mv_dst[1024];
    const int lane = threadIdx.x;
    const int B = arg_int(a, K4_B), S = arg_int(a, K4_S),
              M = arg_int(a, K4_M), C = arg_int(a, K4_C),
              K = arg_int(a, K4_K), KC = arg_int(a, K4_KC),
              P = arg_int(a, K4_P);
    const bool active = lane < B;
    const long long L = lane;
    int32_t* status = leaf<int32_t>(a, K4_LANE, L_STATUS);
    int32_t* stack_top = arg_ptr<int32_t>(a, K4_STACK_TOP);
    const bool enabled = *arg_ptr<uint8_t>(a, K4_ENABLED);

    // ---- free ERRORED lanes, reseed DEAD lanes from the stack -------------------
    int st = active ? status[lane] : ST_RUNNING;
    int n_err = 0;
    if (TEL) block_exclusive_scan(active && st == ST_ERRORED, buf, &n_err);
    if (active && st == ST_ERRORED) {
        st = ST_DEAD;
        status[lane] = ST_DEAD;
    }
    const int top = *stack_top;
    const bool dead0 = active && st == ST_DEAD;
    int total;
    const int rrank = block_exclusive_scan(dead0, buf, &total);
    const bool take = dead0 && rrank < top && enabled;
    const int src = static_cast<int>(clampll(top - 1 - rrank, 0, P > 0 ? P - 1 : 0));
    int n_taken;
    const int trank = block_exclusive_scan(take, buf, &n_taken);
    if (take) {
        mv_src[trank] = src;
        mv_dst[trank] = lane;
    }
    __syncthreads();
    for (int m = 0; m < n_taken; ++m)
        copy_row(a, K4_POOL, mv_src[m], K4_LANE, mv_dst[m]);
    __syncthreads();
    st = active ? status[lane] : ST_DEAD;
    const bool running = active && st == ST_RUNNING;
    int n_running;
    block_exclusive_scan(running, buf, &n_running);
    if (lane == 0) {
        *stack_top = top - n_taken;
        *arg_ptr<long long>(a, K4_POPS) += n_taken;
        *arg_ptr<long long>(a, K4_EXECUTED) += n_running;
        if (TEL) {
            long long* lifecycle = arg_ptr<long long>(a, K4_TEL_LIFECYCLE);
            long long* occupancy = arg_ptr<long long>(a, K4_TEL_OCCUPANCY);
            lifecycle[LC_RESEEDS] += n_taken;
            lifecycle[LC_ERR_DEATHS] += n_err;
            occupancy[0] += n_running;
            occupancy[1] += 1;
        }
    }
    if (!active) return;  // no block barrier below

    // ---- fetch + operand planes -----------------------------------------------------
    const int32_t* optab = arg_ptr<const int32_t>(a, K4_OPTAB);
    const int pc = leaf<int32_t>(a, K4_LANE, L_PC)[lane];
    const int sp = leaf<int32_t>(a, K4_LANE, L_SP)[lane];
    const int code_len = leaf<int32_t>(a, K4_LANE, L_CODE_LEN)[lane];
    const int op = pc < code_len
        ? leaf<uint8_t>(a, K4_LANE, L_CODE)[L * C + clampll(pc, 0, C - 1)] : OP_STOP;
    const int32_t* ss = leaf<int32_t>(a, K4_LANE, L_STACK_SYM) + L * S;
    const int sym1 = ss[clampll(sp - 1, 0, S - 1)];
    const int sym2 = ss[clampll(sp - 2, 0, S - 1)];
    const int sym3 = ss[clampll(sp - 3, 0, S - 1)];
    const int pops = optab[4 * op + OPT_POPS];
    const int flags = optab[4 * op + OPT_FLAGS];
    const bool any_sym = (pops >= 1 && sym1) || (pops >= 2 && sym2)
                         || (pops >= 3 && sym3);

    const int32_t* stack = leaf<int32_t>(a, K4_LANE, L_STACK) + L * S * 16;
    const int32_t* a_p = stack + 16 * clampll(sp - 1, 0, S - 1);
    const int32_t* b_p = stack + 16 * clampll(sp - 2, 0, S - 1);
    const int32_t* c_p = stack + 16 * clampll(sp - 3, 0, S - 1);
    int32_t* wa = wscr(a, W_A, lane);
    int32_t* wb = wscr(a, W_B, lane);
    for (int i = 0; i < 16; ++i) { wa[i] = a_p[i]; wb[i] = b_p[i]; }
    bool off_fits, junk;
    const long long off_i = low32(a_p, &off_fits);

    const bool symbolic_env = leaf<uint8_t>(a, K4_LANE, L_SYMBOLIC_ENV)[lane];
    const int env_class = OPF_ENV_CLASS(flags);
    const bool env_var_op = running && symbolic_env && env_class != 0;
    const bool cdl_op = running && symbolic_env && op == OP_CALLDATALOAD;
    const bool cdl_sym_off = cdl_op && sym1 != 0;
    const bool cdl_var = cdl_op && sym1 == 0 && off_fits && off_i < (1LL << 30);

    // memory round trips: a clean MLOAD reads 32 cells (node << 5 | 0..31)
    const int32_t* ms = leaf<int32_t>(a, K4_LANE, L_MEM_SYM) + L * M;
    const bool mstore_sym_val = running && op == OP_MSTORE && sym1 == 0 && sym2 != 0;
    const bool mload_mask = running && op == OP_MLOAD && sym1 == 0;
    const int32_t first = ms[clampll(off_i, 0, M - 1)];
    bool cells_sym = false, cells_match = true;
    for (int j = 0; j < 32; ++j) {
        const int32_t cell = ms[clampll(off_i + j, 0, M - 1)];
        cells_sym = cells_sym || cell != 0;
        const int32_t expected = first != 0 ? ((first >> 5) << 5) + j : 0;
        cells_match = cells_match && cell == expected;
    }
    const bool mload_clean = cells_sym && first != 0 && (first & 31) == 0 && cells_match;
    const int mload_node = mload_clean ? (first >> 5) : 0;
    const bool mload_dirty = mload_mask && cells_sym && !mload_clean;

    // storage
    const bool sload_mask = running && op == OP_SLOAD;
    const bool sstore_mask = running && op == OP_SSTORE;
    const int slot = table_find(leaf<int32_t>(a, K4_LANE, L_STORAGE_KEYS) + L * K * 16,
                                leaf<uint8_t>(a, K4_LANE, L_STORAGE_USED) + L * K,
                                K, a_p);
    const bool found = slot >= 0;
    const int sload_node = (sload_mask && found)
        ? leaf<int32_t>(a, K4_LANE, L_STORAGE_SYM)[L * K + slot] : 0;

    // ---- classify: FORK / PAUSE ---------------------------------------------------
    const int cap = arg_int(a, K4_CAP);
    const int cond_cls = arg_ptr<int32_t>(a, K4_CLS)[clampll(sym2, 0, cap - 1)];
    const bool predictable = (cond_cls & arg_int(a, K4_PRED_MASK)) != 0;
    const bool cond_room = leaf<int32_t>(a, K4_LANE, L_COND_COUNT)[lane] + 1 <= KC;
    const bool jumpi_sym_cond = running && op == OP_JUMPI && sym2 != 0 && sym1 == 0;
    const bool jumpi_host = jumpi_sym_cond && (predictable || !cond_room);
    const bool jumpi_fork = jumpi_sym_cond && !jumpi_host;
    const bool frozen_fork = st == ST_FORKING && op == OP_JUMPI && sym2 != 0
                             && sym1 == 0 && cond_room && !predictable;
    const bool sload_cold = sload_mask && sym1 == 0
        && leaf<uint8_t>(a, K4_LANE, L_STORAGE_BASE_SYM)[lane] && !found;
    const bool force_fork = jumpi_fork || sload_cold;

    // ---- classify: ESCAPE -----------------------------------------------------------
    auto range_has_sym = [&](long long off, long long size) {
        long long end = off + size < M ? off + size : M;
        for (long long j = off < 0 ? 0 : off; j < end; ++j)
            if (ms[j]) return true;
        return false;
    };
    const bool sym_repr = flags & (OPF_SYM_OK | OPF_PLUMBING);
    const bool esc_always = running && (op == OP_STOP || op == OP_RETURN
                                        || op == OP_REVERT || op == OP_INVALID);
    const bool reads_mem = op == OP_SHA3 || op == OP_RETURN || op == OP_REVERT;
    bool esc = any_sym && !sym_repr && !mstore_sym_val && !(sload_mask || sstore_mask);
    esc = esc || (running && (op == OP_JUMP || op == OP_JUMPI) && sym1 != 0);
    esc = esc || jumpi_host;
    esc = esc || (running && (op == OP_MSTORE || op == OP_MLOAD) && sym1 != 0);
    esc = esc || cdl_sym_off || mload_dirty;
    esc = esc || ((sload_mask || sstore_mask) && sym1 != 0);
    if (running && reads_mem && sym1 == 0 && sym2 == 0)
        esc = esc || range_has_sym(off_i, clampll(low32(b_p, &junk), 0, M));
    esc = esc || (running && symbolic_env
                  && (op == OP_CALLDATACOPY || op == OP_SELFBALANCE));
    if (running && (op == OP_CODECOPY || op == OP_RETURNDATACOPY))
        esc = esc || range_has_sym(off_i, clampll(low32(c_p, &junk), 0, M));
    if (running && op == OP_MCOPY) esc = esc || range_has_sym(0, M);
    const bool force_escape = (esc || esc_always) && !force_fork;

    if (TEL) {
        // the where-chain of symstep.py:836-858: the last matching cause wins
        int cause = N_ESC_CAUSES;
        if (force_escape) {
            bool region = false;
            if (running && reads_mem && sym1 == 0 && sym2 == 0)
                region = range_has_sym(off_i, clampll(low32(b_p, &junk), 0, M));
            if (running && (op == OP_CODECOPY || op == OP_RETURNDATACOPY))
                region = region || range_has_sym(off_i, clampll(low32(c_p, &junk), 0, M));
            if (running && op == OP_MCOPY) region = region || range_has_sym(0, M);
            cause = EC_HOST_OP;
            if (region) cause = EC_SYM_MEM_REGION;
            if ((sload_mask || sstore_mask) && sym1 != 0) cause = EC_SYM_STORAGE_KEY;
            if (mload_dirty) cause = EC_DIRTY_MLOAD;
            if ((running && (op == OP_MSTORE || op == OP_MLOAD) && sym1 != 0) || cdl_sym_off)
                cause = EC_SYM_MEM_OFF;
            if (jumpi_host) cause = EC_DETECTOR_BRANCH;
            if (running && (op == OP_JUMP || op == OP_JUMPI) && sym1 != 0)
                cause = EC_SYM_JUMP_DEST;
            if (esc_always) cause = EC_HALT;
        }
        iscr(a, I_TEL_CAUSE)[lane] = cause;
        // the fleet slot of a running lane's seeding context (-1: none)
        const int n_ctx = arg_int(a, K4_TEL_N_CTX);
        int slot = -1;
        if (running && arg_int(a, K4_TEL_N_FLEET) > 0) {
            const int ctx = leaf<int32_t>(a, K4_LANE, L_CTX_ID)[lane];
            slot = arg_ptr<const int32_t>(a, K4_TEL_FLEET_SLOTS)[clampll(ctx, 0, n_ctx - 1)];
        }
        iscr(a, I_TEL_SLOT)[lane] = slot;
    }

    iscr(a, I_OP)[lane] = op;
    iscr(a, I_SYM1)[lane] = sym1;
    iscr(a, I_SYM2)[lane] = sym2;
    iscr(a, I_PRE_SP)[lane] = sp;
    iscr(a, I_PRE_PC)[lane] = pc;
    iscr(a, I_MLOAD_NODE)[lane] = mload_node;
    iscr(a, I_SLOAD_NODE)[lane] = sload_node;
    iscr(a, I_VAR_CLASS)[lane] = cdl_var ? V_CALLDATA_WORD : env_class;
    iscr(a, I_VAR_QUAL)[lane] = cdl_var ? static_cast<int>(off_i) : 0;
    iscr(a, I_ZERO)[lane] = 0;
    iscr(a, I_VAR_OP)[lane] = VAR_TAG;
    fscr(a, F_FORCE_ESCAPE)[lane] = force_escape;
    fscr(a, F_FORCE_FORK)[lane] = force_fork;
    fscr(a, F_WAS_RUNNING)[lane] = running;
    fscr(a, F_JUMPI_FORK)[lane] = jumpi_fork;
    fscr(a, F_FROZEN_FORK)[lane] = frozen_fork;
    fscr(a, F_SLOAD_COLD)[lane] = sload_cold;
    fscr(a, F_MSTORE_SYM_VAL)[lane] = mstore_sym_val;
    fscr(a, F_MLOAD_CLEAN)[lane] = mload_mask && mload_clean;
    fscr(a, F_ANY_SYM)[lane] = any_sym;
    fscr(a, F_CDL_VAR)[lane] = cdl_var;
    fscr(a, F_ENV_VAR_OP)[lane] = env_var_op;
    fscr(a, F_SSTORE)[lane] = sstore_mask;
}

// after K2: which lanes allocate which nodes
__global__ void sym_mid1_kernel(Args a) {
    const int lane = threadIdx.x;
    if (lane >= arg_int(a, K4_B)) return;
    const int32_t* optab = arg_ptr<const int32_t>(a, K4_OPTAB);
    const int op = iscr(a, I_OP)[lane];
    const bool advanced = fscr(a, F_WAS_RUNNING)[lane]
        && !fscr(a, F_FORCE_ESCAPE)[lane] && !fscr(a, F_FORCE_FORK)[lane]
        && leaf<int32_t>(a, K4_LANE, L_STATUS)[lane] == ST_RUNNING;
    const bool sym_compute = advanced && fscr(a, F_ANY_SYM)[lane]
                             && (optab[4 * op + OPT_FLAGS] & OPF_SYM_OK);
    const int pops = optab[4 * op + OPT_POPS];
    fscr(a, F_ADVANCED)[lane] = advanced;
    fscr(a, F_WANT_CA)[lane] = sym_compute && iscr(a, I_SYM1)[lane] == 0 && pops >= 1;
    fscr(a, F_WANT_CB)[lane] = sym_compute && iscr(a, I_SYM2)[lane] == 0 && pops >= 2;
    fscr(a, F_WANT_R)[lane] = sym_compute;
    fscr(a, F_WANT_E)[lane] = advanced
        && (fscr(a, F_ENV_VAR_OP)[lane] || fscr(a, F_CDL_VAR)[lane]);
}

// after the CONST allocations: operand nodes of the result rows
__global__ void sym_mid2_kernel(Args a) {
    const int lane = threadIdx.x;
    if (lane >= arg_int(a, K4_B)) return;
    const int sym1 = iscr(a, I_SYM1)[lane], sym2 = iscr(a, I_SYM2)[lane];
    iscr(a, I_NODE_A)[lane] = sym1 != 0 ? sym1 : iscr(a, I_IDS_CA)[lane];
    iscr(a, I_NODE_B)[lane] = sym2 != 0 ? sym2 : iscr(a, I_IDS_CB)[lane];
}

template <bool TEL>
__global__ void sym_post_kernel(Args a) {
    __shared__ int buf[1024];
    __shared__ int mv_src[1024], mv_dst[1024], mv_base[1024], dead_map[1024];
    // K9's block counters: op classes, causes, lifecycle, tags, fleet slots
    __shared__ int tel_count[N_OP_CLASSES + N_ESC_CAUSES + N_LIFECYCLE
                             + 2 * MAX_TEL_SLOTS];
    const int lane = threadIdx.x;
    const int B = arg_int(a, K4_B), S = arg_int(a, K4_S),
              M = arg_int(a, K4_M), C = arg_int(a, K4_C),
              K = arg_int(a, K4_K), KC = arg_int(a, K4_KC),
              P = arg_int(a, K4_P), E = arg_int(a, K4_E);
    const bool active = lane < B;
    const long long L = lane;
    const int32_t* optab = arg_ptr<const int32_t>(a, K4_OPTAB);
    const bool enabled = *arg_ptr<uint8_t>(a, K4_ENABLED);
    int32_t* status = leaf<int32_t>(a, K4_LANE, L_STATUS);
    int32_t* sp_p = leaf<int32_t>(a, K4_LANE, L_SP);
    int32_t* pc_p = leaf<int32_t>(a, K4_LANE, L_PC);
    int32_t* stack_top = arg_ptr<int32_t>(a, K4_STACK_TOP);
    int32_t* esc_count = arg_ptr<int32_t>(a, K4_ESC_COUNT);

    int op = 0, sym1 = 0, sym2 = 0, pre_sp = 0, pre_pc = 0;
    bool advanced = false, off_fits = false, overflow = false;
    long long off_i = 0;
    if (TEL)
        for (int i = lane; i < N_OP_CLASSES + N_ESC_CAUSES + N_LIFECYCLE
                               + 2 * MAX_TEL_SLOTS; i += blockDim.x)
            tel_count[i] = 0;
    if (active) {
        op = iscr(a, I_OP)[lane];
        sym1 = iscr(a, I_SYM1)[lane];
        sym2 = iscr(a, I_SYM2)[lane];
        pre_sp = iscr(a, I_PRE_SP)[lane];
        pre_pc = iscr(a, I_PRE_PC)[lane];
        advanced = fscr(a, F_ADVANCED)[lane];
        off_i = low32(wscr(a, W_A, lane), &off_fits);

        // ---- arena exhaustion kills the lane ---------------------------------------
        overflow = fscr(a, F_OVF_CA)[lane] || fscr(a, F_OVF_CB)[lane]
                   || fscr(a, F_OVF_R)[lane] || fscr(a, F_OVF_E)[lane];
        if (overflow) status[lane] = ST_DEAD;

        // ---- stack plane ----------------------------------------------------------
        int new_top;
        if (fscr(a, F_WANT_R)[lane]) new_top = iscr(a, I_IDS_R)[lane];
        else if (fscr(a, F_WANT_E)[lane]) new_top = iscr(a, I_IDS_E)[lane];
        else if (fscr(a, F_MLOAD_CLEAN)[lane]) new_top = iscr(a, I_MLOAD_NODE)[lane];
        else new_top = iscr(a, I_SLOAD_NODE)[lane];
        int32_t* ss = leaf<int32_t>(a, K4_LANE, L_STACK_SYM) + L * S;
        const bool is_dup = op >= 0x80 && op <= 0x8F;
        const bool is_swap = op >= 0x90 && op <= 0x9F;
        const bool writes_result = optab[4 * op + OPT_PUSHES] >= 1 && !is_swap;
        const int dup_node = ss[clampll(pre_sp - clampll(op - 0x7F, 1, 16), 0, S - 1)];
        const int new_sp = sp_p[lane];
        if (advanced) {
            if (writes_result) ss[clampll(new_sp - 1, 0, S - 1)] = is_dup ? dup_node : new_top;
            for (int j = new_sp < 0 ? 0 : new_sp; j < S; ++j) ss[j] = 0;
            if (is_swap) {
                const long long ti = clampll(pre_sp - 1, 0, S - 1);
                const long long di = clampll(pre_sp - 1 - clampll(op - 0x8F, 1, 16), 0, S - 1);
                const int t = ss[ti], d = ss[di];
                ss[ti] = d;
                ss[di] = t;
            }
        }

        // ---- memory plane -------------------------------------------------------------
        int32_t* ms = leaf<int32_t>(a, K4_LANE, L_MEM_SYM) + L * M;
        if (advanced && fscr(a, F_MSTORE_SYM_VAL)[lane])
            for (int j = 0; j < 32; ++j) ms[clampll(off_i + j, 0, M - 1)] = (sym2 << 5) + j;
        if (advanced && op == OP_MSTORE && sym1 == 0 && sym2 == 0)
            for (int j = 0; j < 32; ++j) ms[clampll(off_i + j, 0, M - 1)] = 0;
        if (advanced && op == OP_MSTORE8 && sym1 == 0 && sym2 == 0)
            ms[clampll(off_i, 0, M - 1)] = 0;

        // ---- storage plane: every concrete-key SSTORE marks its slot ------------------
        if (advanced && fscr(a, F_SSTORE)[lane] && sym1 == 0) {
            const int slot = table_find(
                leaf<int32_t>(a, K4_LANE, L_STORAGE_KEYS) + L * K * 16,
                leaf<uint8_t>(a, K4_LANE, L_STORAGE_USED) + L * K, K,
                wscr(a, W_A, lane));
            if (slot >= 0) {
                leaf<int32_t>(a, K4_LANE, L_STORAGE_SYM)[L * K + slot] = sym2;
                leaf<uint8_t>(a, K4_LANE, L_STORAGE_DIRTY)[L * K + slot] = 1;
            }
        }

        // ---- fork marker, branch count, last jump ------------------------------------
        if (fscr(a, F_WAS_RUNNING)[lane]) {
            if (fscr(a, F_JUMPI_FORK)[lane]) leaf<int32_t>(a, K4_LANE, L_FORK_COND)[lane] = sym2;
            else if (fscr(a, F_SLOAD_COLD)[lane]) leaf<int32_t>(a, K4_LANE, L_FORK_COND)[lane] = 0;
        }
        if (advanced && op == OP_JUMPI) leaf<int32_t>(a, K4_LANE, L_BRANCHES)[lane] += 1;
        if (advanced && op == OP_JUMP) leaf<int32_t>(a, K4_LANE, L_LAST_JUMP)[lane] = pre_pc;
    }
    __syncthreads();

    // ---- escape buffering: halted / host-owned lanes move to the buffer ---------------
    const int ecount = *esc_count;
    const bool esc_now = active && enabled && status[lane] == ST_ESCAPED;
    int n_esc;
    const int erank = block_exclusive_scan(esc_now, buf, &n_esc);
    const bool put = esc_now && erank < E - ecount;
    if (put) {
        mv_src[erank] = lane;
        mv_dst[erank] = ecount + erank;
    }
    int room = E - ecount;
    const int n_put = n_esc < room ? n_esc : (room > 0 ? room : 0);
    __syncthreads();
    for (int m = 0; m < n_put; ++m) copy_row(a, K4_LANE, mv_src[m], K4_ESC, mv_dst[m]);
    __syncthreads();
    if (put) status[lane] = ST_DEAD;
    const int esc_used = ecount + n_put;
    __syncthreads();

    // ---- on-device JUMPI forking --------------------------------------------------------
    const bool want = active && (fscr(a, F_JUMPI_FORK)[lane] || fscr(a, F_FROZEN_FORK)[lane]);
    const bool is_dead = active && status[lane] == ST_DEAD;
    int n_dead;
    const int dead_rank = block_exclusive_scan(is_dead, buf, &n_dead);
    if (is_dead) dead_map[dead_rank] = lane;
    int n_want;
    const int fork_rank = block_exclusive_scan(want, buf, &n_want);
    const bool have_target = want && fork_rank < n_dead;
    const int top2 = *stack_top;
    const bool push_want = want && !have_target && enabled;
    int n_push_want;
    const int push_rank = block_exclusive_scan(push_want, buf, &n_push_want);
    const bool push = push_want && push_rank < P - top2;
    const bool spill_want = push_want && !push;
    int n_spill_want;
    const int spill_rank = block_exclusive_scan(spill_want, buf, &n_spill_want);
    const bool spill = spill_want && spill_rank < E - esc_used;
    const bool act = have_target || push || spill;
    int n_act, n_push, n_spill;
    const int act_rank = block_exclusive_scan(act, buf, &n_act);
    block_exclusive_scan(push, buf, &n_push);
    block_exclusive_scan(spill, buf, &n_spill);

    int count = 0;
    bool dest_ok = true;
    if (act) {
        // the forker row becomes the post-fork template: sp -= 2, gas charged,
        // +cond appended, dead stack_sym slots cleared
        int32_t* conds = leaf<int32_t>(a, K4_LANE, L_CONDS) + L * KC;
        int32_t* ccount = leaf<int32_t>(a, K4_LANE, L_COND_COUNT) + lane;
        count = static_cast<int>(clampll(*ccount, 0, KC - 1));
        const int sp_fork = pre_sp - 2;
        sp_p[lane] = sp_fork;
        leaf<long long>(a, K4_LANE, L_GAS_USED)[lane] += optab[4 * op + OPT_GAS];
        conds[count] = sym2;
        *ccount += 1;
        leaf<int32_t>(a, K4_LANE, L_BRANCHES)[lane] += 1;
        int32_t* ss = leaf<int32_t>(a, K4_LANE, L_STACK_SYM) + L * S;
        for (int j = sp_fork < 0 ? 0 : sp_fork; j < S; ++j) ss[j] = 0;
        mv_src[act_rank] = lane;
        if (have_target) { mv_base[act_rank] = K4_LANE; mv_dst[act_rank] = dead_map[fork_rank]; }
        else if (push) { mv_base[act_rank] = K4_POOL; mv_dst[act_rank] = top2 + push_rank; }
        else { mv_base[act_rank] = K4_ESC; mv_dst[act_rank] = esc_used + spill_rank; }
    }
    __syncthreads();
    for (int m = 0; m < n_act; ++m) copy_row(a, K4_LANE, mv_src[m], mv_base[m], mv_dst[m]);
    __syncthreads();
    if (act) {
        // the fall-through sibling: pc + 1, flipped condition, RUNNING
        const int base = mv_base[act_rank];
        const long long row = mv_dst[act_rank];
        leaf<int32_t>(a, base, L_PC)[row] = pre_pc + 1;
        leaf<int32_t>(a, base, L_STATUS)[row] = ST_RUNNING;
        leaf<int32_t>(a, base, L_CONDS)[row * KC + count] = -sym2;
        leaf<int32_t>(a, base, L_FORK_COND)[row] = 0;
        // the forker takes the jump, or dies on an invalid destination
        const int code_len = leaf<int32_t>(a, K4_LANE, L_CODE_LEN)[lane];
        dest_ok = off_fits && off_i < code_len
            && leaf<uint8_t>(a, K4_LANE, L_JUMPDEST)[L * C + clampll(off_i, 0, C - 1)];
        pc_p[lane] = static_cast<int32_t>(static_cast<uint32_t>(off_i));
        status[lane] = dest_ok ? ST_RUNNING : ST_DEAD;
        leaf<int32_t>(a, K4_LANE, L_FORK_COND)[lane] = 0;
    }
    if (lane == 0) {
        *stack_top = top2 + n_push;
        *esc_count = esc_used + n_spill;
        *arg_ptr<long long>(a, K4_PUSHES) += n_push;
        *arg_ptr<long long>(a, K4_FORKS) += n_act;
    }
    if (!TEL) return;

    // ---- K9: the telemetry plane ------------------------------------------------------
    int* op_count = tel_count;
    int* cause_count = op_count + N_OP_CLASSES;
    int* lc_count = cause_count + N_ESC_CAUSES;
    int* tag_count = lc_count + N_LIFECYCLE;
    int* fleet_count = tag_count + MAX_TEL_SLOTS;
    const int n_tags = arg_int(a, K4_TEL_N_TAGS), n_fleet = arg_int(a, K4_TEL_N_FLEET);
    if (active) {
        const bool running = fscr(a, F_WAS_RUNNING)[lane];
        const bool frozen_fork = fscr(a, F_FROZEN_FORK)[lane];
        if (running) {
            atomicAdd(&op_count[OPF_OP_CLASS(optab[4 * op + OPT_FLAGS])], 1);
            const int32_t* tag_pcs = arg_ptr<const int32_t>(a, K4_TEL_TAG_PCS);
            for (int k = 0; k < n_tags; ++k)
                if (pre_pc == tag_pcs[k]) atomicAdd(&tag_count[k], 1);
        }
        const int cause = iscr(a, I_TEL_CAUSE)[lane];
        if (cause < N_ESC_CAUSES) atomicAdd(&cause_count[cause], 1);
        const int slot = iscr(a, I_TEL_SLOT)[lane];
        if (slot >= 0 && slot < n_fleet) atomicAdd(&fleet_count[slot], 1);
        const bool lc[N_LIFECYCLE] = {
            false, false, overflow, act && !dest_ok, put, esc_now && !put,
            want && !act, static_cast<bool>(fscr(a, F_SLOAD_COLD)[lane]),
            have_target, push, spill, frozen_fork && act};
        for (int k = LC_OVERFLOW_KILLS; k < N_LIFECYCLE; ++k)
            if (lc[k]) atomicAdd(&lc_count[k], 1);
    }
    __syncthreads();
    const int n_counts = N_OP_CLASSES + N_ESC_CAUSES + N_LIFECYCLE;
    for (int i = lane; i < n_counts + n_tags + n_fleet; i += blockDim.x) {
        long long* dst;
        int value;
        if (i < N_OP_CLASSES) {
            dst = arg_ptr<long long>(a, K4_TEL_OP_HIST) + i;
            value = op_count[i];
        } else if (i < N_OP_CLASSES + N_ESC_CAUSES) {
            dst = arg_ptr<long long>(a, K4_TEL_ESC_CAUSE) + (i - N_OP_CLASSES);
            value = tel_count[i];
        } else if (i < n_counts) {
            const int k = i - N_OP_CLASSES - N_ESC_CAUSES;
            if (k < LC_OVERFLOW_KILLS) continue;  // sym_pre's
            dst = arg_ptr<long long>(a, K4_TEL_LIFECYCLE) + k;
            value = lc_count[k];
        } else if (i < n_counts + n_tags) {
            dst = arg_ptr<long long>(a, K4_TEL_TAG_OCC) + (i - n_counts);
            value = tag_count[i - n_counts];
        } else {
            dst = arg_ptr<long long>(a, K4_TEL_FLEET_OCC) + (i - n_counts - n_tags);
            value = fleet_count[i - n_counts - n_tags];
        }
        *dst += value;
    }
    if (lane == 0) {
        long long* hwm = arg_ptr<long long>(a, K4_TEL_HWM);
        const long long tops[2] = {top2 + n_push, esc_used + n_spill};
        for (int k = 0; k < 2; ++k)
            if (tops[k] > hwm[k]) hwm[k] = tops[k];
    }
}

namespace {

int launch_block(void (*kernel)(Args), const long long* values, int n,
                 void* stream) {
    Args a = mtpu_pack(values, n);
    const int batch = static_cast<int>(a.v[K4_B]);
    if (batch <= 0 || batch > 1024) return 1;  // cudaErrorInvalidValue
    int threads = 32;
    while (threads < batch) threads <<= 1;
    MTPU_LAUNCH(kernel, 1, threads, stream, a);
    return MTPU_LAUNCH_STATUS();
}

}  // namespace

MTPU_EXPORT int mtpu_sym_pre(const long long* v, int n, void* stream) {
    return launch_block(sym_pre_kernel<false>, v, n, stream);
}

MTPU_EXPORT int mtpu_sym_pre_tel(const long long* v, int n, void* stream) {
    return launch_block(sym_pre_kernel<true>, v, n, stream);
}

MTPU_EXPORT int mtpu_sym_mid1(const long long* v, int n, void* stream) {
    return launch_block(sym_mid1_kernel, v, n, stream);
}

MTPU_EXPORT int mtpu_sym_mid2(const long long* v, int n, void* stream) {
    return launch_block(sym_mid2_kernel, v, n, stream);
}

MTPU_EXPORT int mtpu_sym_post(const long long* v, int n, void* stream) {
    return launch_block(sym_post_kernel<false>, v, n, stream);
}

MTPU_EXPORT int mtpu_sym_post_tel(const long long* v, int n, void* stream) {
    return launch_block(sym_post_kernel<true>, v, n, stream);
}
