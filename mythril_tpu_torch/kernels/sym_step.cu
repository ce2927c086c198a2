// Kernel K4: the symbolic frontier step around kernel K2, with kernel K3's
// four per-step allocations folded in.
//
// Replaces mythril_tpu/parallel/symstep.py:347 `sym_step` as fused by
// `run_chunk` (961), `sym_step_many` (974) and `sym_step_many_counted`
// (990), for the scalar and the sharded (segmented) scheduler. A step is
// two host calls around the concrete step K2 (and K1 through it):
//
//   mtpu_sym_pre   seed_count, seed_seg, seed_apply, move: free ERRORED
//                  lanes, reseed DEAD lanes from the DFS stack by rank
//                  (symstep.py:364-391); classify: fetch and classify every
//                  lane as FORK / cold-SLOAD pause / ESCAPE (464-537)
//   mtpu_sym_post  alloc_count, alloc_seg: the CONST, result and env-VAR
//                  allocations' ranks and bump pointers (K3, arena.py:105,
//                  146); planes: the nodes, then the stack, memory and
//                  storage planes (583-653, `_sym_stack_update` 913);
//                  esc_seg, esc_apply, move: escaped rows into the escape
//                  buffer by rank (655-681); fork_seg, fork_apply, move:
//                  fork symbolic JUMPIs: claim a DEAD lane, push onto the
//                  stack or spill into the escape buffer (683-820)
//
// What bounds it on the H100. The work a step must do is small (the moved
// rows, about 39 KB each at the frontier's default geometry, and a few
// hundred bytes of planes per lane), so the step is bound by latency: by
// how many SMs share the row copies and the per-lane scans, and by the
// launches. One block with a thread per lane, copying whole rows itself,
// would use one SM of 132 and take at most 1024 lanes. Instead:
//
//  * Lanes are tiled over blocks of K4_LPB lanes. Every rank is a global
//    exclusive scan: a tile's block scan (`tile_scan`, stored per lane and
//    per tile), then a one-block launch (`*_seg`) that prefixes the tile
//    totals and settles what is decided per segment (counts, new tops,
//    counters, each written once), then the consumer launch, which adds the
//    tile prefix. A segment (one of D shards, B/D lanes) may span tiles or
//    share one; its ranks and total are differences of global ranks. No
//    rank comes from an atomic, so lane placement, pool rows and arena ids
//    equal the JAX package's, at any lane count.
//  * Row moves are launches of their own (`sym_move`): the plan launches
//    write a move list (source set and row, destination set and row) and
//    the move launch walks a (move, slice of the row) grid, copying each
//    slice with 16-byte accesses where a leaf's base, row size and offset
//    allow. The fall-through sibling's and the forker's few changed fields
//    are patched by the block that copied them.
//  * The wide per-lane work (the 32 memory cells of an MLOAD, the symbolic
//    ranges of SHA3/RETURN/copies, the storage table, the memory and stack
//    plane writes) runs K4_GROUP threads per lane (a warp on the card),
//    reduced through shared memory.
//  * K3's four allocations per step run inside these launches: the ranks
//    come from the same scans, ids and rows follow arena.cuh's rules.
//  * No launch waits on another block: what needs every block done is the
//    next launch, so a chunk of steps captures as one CUDA graph.
//
// Kernel K9, the telemetry plane (symstep.py:822-908 with 359-360), is the
// `TEL = true` instantiation of the launches that count, with no launch of
// its own; the `TEL = false` program is the plane-free step. Counts are
// summed per block in shared memory and added to the plane with atomics
// (sums commute, so they are exact); what is decided per segment is counted
// by the one-block launches; the high-water marks read the step's final
// tops in its last launch.
#include "arena.cuh"

namespace {

enum { V_CALLDATA_WORD = 1 };

// escape causes (symstep.ESC_CAUSE_NAMES) and lifecycle counters
// (symstep.LIFECYCLE_NAMES) by index
enum { EC_HALT = 0, EC_SYM_JUMP_DEST = 1, EC_DETECTOR_BRANCH = 2,
       EC_SYM_MEM_OFF = 3, EC_DIRTY_MLOAD = 4, EC_SYM_STORAGE_KEY = 5,
       EC_SYM_MEM_REGION = 6, EC_HOST_OP = 7 };
enum { LC_RESEEDS = 0, LC_ERR_DEATHS = 1, LC_OVERFLOW_KILLS = 2,
       LC_BAD_JUMP_DEATHS = 3, LC_ESC_BUFFERED = 4, LC_ESC_FROZEN = 5,
       LC_FORK_WAITS = 6, LC_COLD_SLOADS = 7, LC_FORKS_CLAIMED = 8,
       LC_FORKS_PUSHED = 9, LC_FORKS_SPILLED = 10, LC_FROZEN_REVIVED = 11 };

enum { MAX_LPB = 64, SEG_THREADS = 256, MOVE_THREADS = 128, MOVE_ROWS = 32,
       NO_SLOT = 0x7FFFFFFF };

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void add64(long long* p, long long v) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
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

__device__ __forceinline__ int32_t* wscr(const Args& a, int row, long long lane) {
    return arg_ptr<int32_t>(a, K4_WSCR)
           + (static_cast<long long>(row) * arg_int(a, K4_B) + lane) * 16;
}

__device__ __forceinline__ int* scan_row(const Args& a, int c) {
    return arg_ptr<int>(a, K4_SCAN) + static_cast<long long>(c) * arg_int(a, K4_B);
}

__device__ __forceinline__ int* tile_tot(const Args& a, int c) {
    return arg_ptr<int>(a, K4_BTOT) + static_cast<long long>(c) * arg_int(a, K4_NB);
}

__device__ __forceinline__ int* tile_pre(const Args& a, int c) {
    return arg_ptr<int>(a, K4_BPRE) + static_cast<long long>(c) * (arg_int(a, K4_NB) + 1);
}

__device__ __forceinline__ int* seg_row(const Args& a, int field) {
    return arg_ptr<int>(a, K4_SEG) + static_cast<long long>(field) * arg_int(a, K4_D);
}

__device__ __forceinline__ int* move_row(const Args& a, int field) {
    return arg_ptr<int>(a, K4_MOVES) + static_cast<long long>(field) * arg_int(a, K4_B);
}

__device__ __forceinline__ long long* tel_counter(const Args& a, int slot) {
    return arg_ptr<long long>(a, slot);
}

// low 32 bits of 16 stored limbs and whether no higher bit is set
__device__ __forceinline__ long long low32(const int32_t* w, bool* fits) {
    bool f = true;
    for (int i = 2; i < 16; ++i) f = f && w[i] == 0;
    *fits = f;
    return static_cast<long long>((static_cast<uint32_t>(w[0]) & 0xFFFFu)
                                  | ((static_cast<uint32_t>(w[1]) & 0xFFFFu) << 16));
}

// This thread's place in a launch over lanes: blockDim.x = K4_LPB lanes
// times the launch's threads per lane (1 for the narrow launches,
// K4_GROUP for the wide ones).
struct Lanes {
    int B, D, seg_len, g;
    int lane, sub, slot;  // slot: the lane's index within the block
    bool active, leader;  // a real lane; the lane's first thread
};

__device__ __forceinline__ Lanes lanes_of(const Args& a) {
    Lanes l;
    l.B = arg_int(a, K4_B);
    l.D = arg_int(a, K4_D);
    l.seg_len = l.B / l.D;
    const int lpb = arg_int(a, K4_LPB);
    l.g = blockDim.x / lpb;
    l.slot = threadIdx.x / l.g;
    l.sub = threadIdx.x % l.g;
    l.lane = blockIdx.x * lpb + l.slot;
    l.active = l.lane < l.B;
    l.leader = l.sub == 0;
    return l;
}

// Every thread of the block calls it. `v` packs up to four 16-bit counts of
// the thread's lane (read from its leader); stores each lane's exclusive
// rank within the tile and the tile's totals for components c0..c0+n-1.
__device__ void tile_scan(const Args& a, const Lanes& l, int c0, int n,
                          unsigned long long v, unsigned long long* buf) {
    unsigned long long total;
    const unsigned long long excl = block_exclusive_scan(
        l.leader && l.active ? v : 0ULL, buf, &total);
    for (int k = 0; k < n; ++k) {
        const int shift = 16 * k;
        if (l.leader && l.active)
            scan_row(a, c0 + k)[l.lane] = static_cast<int>((excl >> shift) & 0xFFFF);
        if (threadIdx.x == 0)
            tile_tot(a, c0 + k)[blockIdx.x] = static_cast<int>((total >> shift) & 0xFFFF);
    }
}

// global exclusive rank of position x (0..B) in component c, once the
// component's tiles are prefixed
__device__ __forceinline__ int grank(const Args& a, int c, long long x) {
    const int B = arg_int(a, K4_B);
    if (x >= B) return tile_pre(a, c)[arg_int(a, K4_NB)];
    return tile_pre(a, c)[x / arg_int(a, K4_LPB)] + scan_row(a, c)[x];
}

__device__ __forceinline__ int seg_rank(const Args& a, int c, int lane) {
    const int seg_len = arg_int(a, K4_B) / arg_int(a, K4_D);
    return grank(a, c, lane) - grank(a, c, static_cast<long long>(lane / seg_len) * seg_len);
}

__device__ __forceinline__ int seg_count(const Args& a, int c, long long s) {
    const long long seg_len = arg_int(a, K4_B) / arg_int(a, K4_D);
    return grank(a, c, (s + 1) * seg_len) - grank(a, c, s * seg_len);
}

// one block: the tile prefixes of component c (read after a barrier)
__device__ void prefix_tiles(const Args& a, int c, int* buf) {
    const int nb = arg_int(a, K4_NB);
    const int* tot = tile_tot(a, c);
    int* pre = tile_pre(a, c);
    const int total = runs_scan(
        nb, [&](long long i) { return tot[i]; },
        [&](long long i, int excl, int) { pre[i] = excl; }, buf);
    if (threadIdx.x == 0) pre[nb] = total;
}

// does mem_sym[off, off + size) hold a symbolic byte? (this thread's share)
__device__ __forceinline__ bool range_share(const int32_t* ms, long long off,
                                            long long size, int M, int sub, int g) {
    const long long end = off + size < M ? off + size : M;
    for (long long j = (off < 0 ? 0 : off) + sub; j < end; j += g)
        if (ms[j]) return true;
    return false;
}

// the first used slot of a [n, 16] key table equal to `key`, among this
// thread's slots (NO_SLOT if none)
__device__ __forceinline__ int table_share(const int32_t* keys, const uint8_t* used,
                                           int n, const int32_t* key, int sub, int g) {
    for (int s = sub; s < n; s += g) {
        if (!used[s]) continue;
        bool match = true;
        for (int i = 0; i < 16; ++i) match = match && keys[16 * s + i] == key[i];
        if (match) return s;
    }
    return NO_SLOT;
}

__device__ __forceinline__ ArenaRef arena_of(const Args& a) {
    return {arg_ptr<int32_t>(a, K4_AR_OP), arg_ptr<int32_t>(a, K4_AR_A),
            arg_ptr<int32_t>(a, K4_AR_B), arg_ptr<int32_t>(a, K4_AR_C),
            arg_ptr<int32_t>(a, K4_AR_IMM), arg_ptr<int32_t>(a, K4_AR_IMM2),
            arg_ptr<int32_t>(a, K4_CLS), arg_ptr<int32_t>(a, K4_AR_CONST),
            a.v[K4_CAP], a.v[K4_AR_CCAP]};
}

// the move list entry m
__device__ __forceinline__ void put_move(const Args& a, int m, int src_base, long long src_row,
                                         int dst_base, long long dst_row, bool mapped) {
    move_row(a, MV_SRC_BASE)[m] = src_base;
    move_row(a, MV_SRC_ROW)[m] = static_cast<int>(src_row);
    move_row(a, MV_DST_BASE)[m] = dst_base;
    move_row(a, MV_DST_ROW)[m] = static_cast<int>(dst_row);
    move_row(a, MV_DST_MAPPED)[m] = mapped;
}

}  // namespace

// ---- reseeding ------------------------------------------------------------------------

// free ERRORED lanes; the tile scan of DEAD lanes
template <bool TEL>
__global__ void sym_seed_count_kernel(Args a) {
    __shared__ unsigned long long buf[1024];
    __shared__ int n_err;
    const Lanes l = lanes_of(a);
    if (threadIdx.x == 0) n_err = 0;
    __syncthreads();
    bool dead0 = false;
    if (l.active) {
        int32_t* status = leaf<int32_t>(a, K4_LANE, L_STATUS);
        int st = status[l.lane];
        if (st == ST_ERRORED) {
            if (TEL) atomicAdd(&n_err, 1);
            st = ST_DEAD;
            status[l.lane] = ST_DEAD;
        }
        dead0 = st == ST_DEAD;
    }
    tile_scan(a, l, SC_DEAD0, 1, dead0, buf);
    if (TEL && threadIdx.x == 0 && n_err)
        add64(tel_counter(a, K4_TEL_LIFECYCLE) + LC_ERR_DEATHS, n_err);
}

// segment d's DEAD lanes take from the top of pool segment d: the counts,
// the new tops, the pops
template <bool TEL>
__global__ void sym_seed_seg_kernel(Args a) {
    __shared__ int buf[SEG_THREADS];
    prefix_tiles(a, SC_DEAD0, buf);
    __syncthreads();
    const bool enabled = *arg_ptr<uint8_t>(a, K4_ENABLED);
    int32_t* stack_top = arg_ptr<int32_t>(a, K4_STACK_TOP);
    int* top0 = seg_row(a, SG_TOP0);
    int* take = seg_row(a, SG_TAKE);
    int* base = seg_row(a, SG_TAKE_BASE);
    const int total = runs_scan(
        arg_int(a, K4_D),
        [&](long long s) {
            const int dead = seg_count(a, SC_DEAD0, s), top = stack_top[s];
            return enabled && top > 0 ? (dead < top ? dead : top) : 0;
        },
        [&](long long s, int excl, int v) {
            top0[s] = stack_top[s];
            take[s] = v;
            base[s] = excl;
            stack_top[s] = top0[s] - v;
        },
        buf);
    if (threadIdx.x == 0) {
        *arg_ptr<long long>(a, K4_POPS) += total;
        arg_ptr<int>(a, K4_NMOVES)[PH_SEED] = total;
        if (TEL) {
            tel_counter(a, K4_TEL_LIFECYCLE)[LC_RESEEDS] += total;
            tel_counter(a, K4_TEL_OCCUPANCY)[1] += 1;
        }
    }
}

// the reseeds' moves: pool row (deepest first) -> DEAD lane
__global__ void sym_seed_apply_kernel(Args a) {
    const Lanes l = lanes_of(a);
    if (!l.active || leaf<int32_t>(a, K4_LANE, L_STATUS)[l.lane] != ST_DEAD) return;
    const int s = l.lane / l.seg_len;
    const int rrank = seg_rank(a, SC_DEAD0, l.lane);
    if (rrank >= seg_row(a, SG_TAKE)[s]) return;
    const long long P = a.v[K4_P];
    const long long src = clampll(s * (P / l.D) + seg_row(a, SG_TOP0)[s] - 1 - rrank, 0,
                                  P > 0 ? P - 1 : 0);
    put_move(a, seg_row(a, SG_TAKE_BASE)[s] + rrank, K4_POOL, src, K4_LANE, l.lane, false);
}

// ---- row moves ------------------------------------------------------------------------

// The moves of one phase over a (move, item) grid: each item is a slice of
// the row (entries of leaves); the block copies it, then patches the fields
// the phase changes in it. The fork phase's last block also takes the
// telemetry high-water marks from the step's final tops.
template <bool TEL>
__global__ void sym_move_kernel(Args a) {
    const int phase = arg_int(a, K4_PHASE);
    const long long n_moves = arg_ptr<const int>(a, K4_NMOVES)[phase];
    const int n_items = arg_int(a, K4_N_ITEMS);
    const int* items = arg_ptr<const int>(a, K4_ITEMS);
    const int* entries = arg_ptr<const int>(a, K4_ENTRIES);
    for (long long w = blockIdx.x; w < n_moves * n_items; w += gridDim.x) {
        const int m = static_cast<int>(w / n_items), item = static_cast<int>(w % n_items);
        const int src_base = move_row(a, MV_SRC_BASE)[m], dst_base = move_row(a, MV_DST_BASE)[m];
        const long long src_row = move_row(a, MV_SRC_ROW)[m];
        long long dst_row = move_row(a, MV_DST_ROW)[m];
        if (move_row(a, MV_DST_MAPPED)[m]) dst_row = arg_ptr<const int>(a, K4_DEAD_MAP)[dst_row];
        copy_item(
            entries, items, item,
            [&](int f) { return arg_ptr<uint8_t>(a, dst_base + f) + dst_row * a.v[K4_ROW_BYTES + f]; },
            [&](int f) {
                return arg_ptr<const uint8_t>(a, src_base + f) + src_row * a.v[K4_ROW_BYTES + f];
            });
        if (phase == PH_SEED) continue;
        __syncthreads();
        if (threadIdx.x != 0) continue;
        for (int e = items[item]; e < items[item + 1]; ++e) {
            const int f = entries[3 * e];
            if (phase == PH_ESC) {
                // the buffered lane is freed once its row is copied
                if (f == L_STATUS) leaf<int32_t>(a, src_base, L_STATUS)[src_row] = ST_DEAD;
                continue;
            }
            // the fall-through sibling: pc + 1, flipped condition, RUNNING;
            // the forker (the source lane) takes the jump or dies on an
            // invalid destination
            const long long x = src_row;
            if (f == L_PC) {
                bool junk;
                leaf<int32_t>(a, dst_base, L_PC)[dst_row] = iscr(a, I_PRE_PC)[x] + 1;
                leaf<int32_t>(a, src_base, L_PC)[x] = static_cast<int32_t>(
                    static_cast<uint32_t>(low32(wscr(a, W_A, x), &junk)));
            } else if (f == L_STATUS) {
                leaf<int32_t>(a, dst_base, L_STATUS)[dst_row] = ST_RUNNING;
                leaf<int32_t>(a, src_base, L_STATUS)[x] =
                    fscr(a, F_DEST_OK)[x] ? ST_RUNNING : ST_DEAD;
            } else if (f == L_FORK_COND) {
                leaf<int32_t>(a, dst_base, L_FORK_COND)[dst_row] = 0;
                leaf<int32_t>(a, src_base, L_FORK_COND)[x] = 0;
            } else if (f == L_CONDS) {
                const long long count = iscr(a, I_COUNT)[x], byte = 4 * count;
                const long long off = entries[3 * e + 1];
                if (byte >= off && byte < off + entries[3 * e + 2])
                    leaf<int32_t>(a, dst_base, L_CONDS)[dst_row * arg_int(a, K4_KC) + count] =
                        -iscr(a, I_SYM2)[x];
            }
        }
    }
    if (TEL && phase == PH_FORK && blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
        // the global rows in use: the sum of the segments' final tops
        // (symstep.py:878-882)
        const int32_t* stack_top = arg_ptr<const int32_t>(a, K4_STACK_TOP);
        const int32_t* esc_count = arg_ptr<const int32_t>(a, K4_ESC_COUNT);
        long long tops[2] = {0, 0};
        for (int d = 0; d < arg_int(a, K4_D); ++d) {
            tops[0] += stack_top[d];
            tops[1] += esc_count[d];
        }
        long long* hwm = tel_counter(a, K4_TEL_HWM);
        for (int k = 0; k < 2; ++k)
            if (tops[k] > hwm[k]) hwm[k] = tops[k];
    }
}

// ---- classification -------------------------------------------------------------------

// fetch and classify every lane; K4_GROUP threads a lane
template <bool TEL>
__global__ void sym_classify_kernel(Args a) {
    enum { R_CSYM, R_CMIS, R_SLOT, R_READS, R_COPY, R_MCOPY, N_RED };
    enum { T_OP = 0, T_CAUSE = T_OP + N_OP_CLASSES, T_TAG = T_CAUSE + N_ESC_CAUSES,
           T_FLEET = T_TAG + MAX_TEL_SLOTS, T_COLD = T_FLEET + MAX_TEL_SLOTS,
           T_RUNNING, N_T };
    __shared__ int red[N_RED][MAX_LPB];
    __shared__ int tel[N_T];
    const Lanes l = lanes_of(a);
    const int S = arg_int(a, K4_S), M = arg_int(a, K4_M), C = arg_int(a, K4_C),
              K = arg_int(a, K4_K), KC = arg_int(a, K4_KC);
    if (l.leader) {
        for (int r = 0; r < N_RED; ++r) red[r][l.slot] = r == R_SLOT ? NO_SLOT : 0;
    }
    for (int i = threadIdx.x; i < N_T; i += blockDim.x) tel[i] = 0;
    __syncthreads();

    // ---- the lane's scalars (every thread of the group reads them) --------------------
    const long long L = l.active ? l.lane : 0;
    const int st = l.active ? leaf<int32_t>(a, K4_LANE, L_STATUS)[L] : ST_DEAD;
    const bool running = l.active && st == ST_RUNNING;
    const int32_t* optab = arg_ptr<const int32_t>(a, K4_OPTAB);
    const int pc = leaf<int32_t>(a, K4_LANE, L_PC)[L];
    const int sp = leaf<int32_t>(a, K4_LANE, L_SP)[L];
    const int code_len = leaf<int32_t>(a, K4_LANE, L_CODE_LEN)[L];
    const int op = pc < code_len
        ? leaf<uint8_t>(a, K4_LANE, L_CODE)[L * C + clampll(pc, 0, C - 1)] : OP_STOP;
    const int32_t* ss = leaf<int32_t>(a, K4_LANE, L_STACK_SYM) + L * S;
    const int sym1 = ss[clampll(sp - 1, 0, S - 1)];
    const int sym2 = ss[clampll(sp - 2, 0, S - 1)];
    const int sym3 = ss[clampll(sp - 3, 0, S - 1)];
    const int pops = optab[4 * op + OPT_POPS];
    const int flags = optab[4 * op + OPT_FLAGS];
    const bool any_sym = (pops >= 1 && sym1) || (pops >= 2 && sym2) || (pops >= 3 && sym3);

    const int32_t* stack = leaf<int32_t>(a, K4_LANE, L_STACK) + L * S * 16;
    const int32_t* a_p = stack + 16 * clampll(sp - 1, 0, S - 1);
    const int32_t* b_p = stack + 16 * clampll(sp - 2, 0, S - 1);
    const int32_t* c_p = stack + 16 * clampll(sp - 3, 0, S - 1);
    bool off_fits, junk;
    const long long off_i = low32(a_p, &off_fits);
    const int32_t* ms = leaf<int32_t>(a, K4_LANE, L_MEM_SYM) + L * M;
    const int32_t first = ms[clampll(off_i, 0, M - 1)];
    const bool reads_mem = op == OP_SHA3 || op == OP_RETURN || op == OP_REVERT;
    const bool reads_range = running && reads_mem && sym1 == 0 && sym2 == 0;
    const bool copy_range = running && (op == OP_CODECOPY || op == OP_RETURNDATACOPY);
    const bool mcopy_range = running && op == OP_MCOPY;

    // ---- the group's shares: MLOAD cells, storage table, symbolic ranges --------------
    if (l.active) {
        bool csym = false, cmis = false;
        for (int j = l.sub; j < 32; j += l.g) {
            const int32_t cell = ms[clampll(off_i + j, 0, M - 1)];
            csym = csym || cell != 0;
            cmis = cmis || cell != (first != 0 ? ((first >> 5) << 5) + j : 0);
        }
        if (csym) atomicMax(&red[R_CSYM][l.slot], 1);
        if (cmis) atomicMax(&red[R_CMIS][l.slot], 1);
        const int slot = table_share(leaf<int32_t>(a, K4_LANE, L_STORAGE_KEYS) + L * K * 16,
                                     leaf<uint8_t>(a, K4_LANE, L_STORAGE_USED) + L * K, K,
                                     a_p, l.sub, l.g);
        if (slot != NO_SLOT) atomicMin(&red[R_SLOT][l.slot], slot);
        if (reads_range && range_share(ms, off_i, clampll(low32(b_p, &junk), 0, M), M, l.sub, l.g))
            atomicMax(&red[R_READS][l.slot], 1);
        if (copy_range && range_share(ms, off_i, clampll(low32(c_p, &junk), 0, M), M, l.sub, l.g))
            atomicMax(&red[R_COPY][l.slot], 1);
        if (mcopy_range && range_share(ms, 0, M, M, l.sub, l.g))
            atomicMax(&red[R_MCOPY][l.slot], 1);
        int32_t* wa = wscr(a, W_A, L);
        int32_t* wb = wscr(a, W_B, L);
        for (int i = l.sub; i < 16; i += l.g) {
            wa[i] = a_p[i];
            wb[i] = b_p[i];
        }
    }
    __syncthreads();

    if (l.active && l.leader) {
        const bool symbolic_env = leaf<uint8_t>(a, K4_LANE, L_SYMBOLIC_ENV)[L];
        const int env_class = OPF_ENV_CLASS(flags);
        const bool env_var_op = running && symbolic_env && env_class != 0;
        const bool cdl_op = running && symbolic_env && op == OP_CALLDATALOAD;
        const bool cdl_sym_off = cdl_op && sym1 != 0;
        const bool cdl_var = cdl_op && sym1 == 0 && off_fits && off_i < (1LL << 30);

        // memory round trips: a clean MLOAD reads 32 cells (node << 5 | 0..31)
        const bool mstore_sym_val = running && op == OP_MSTORE && sym1 == 0 && sym2 != 0;
        const bool mload_mask = running && op == OP_MLOAD && sym1 == 0;
        const bool cells_sym = red[R_CSYM][l.slot], cells_match = !red[R_CMIS][l.slot];
        const bool mload_clean = cells_sym && first != 0 && (first & 31) == 0 && cells_match;
        const int mload_node = mload_clean ? (first >> 5) : 0;
        const bool mload_dirty = mload_mask && cells_sym && !mload_clean;

        // storage
        const bool sload_mask = running && op == OP_SLOAD;
        const bool sstore_mask = running && op == OP_SSTORE;
        const int slot = red[R_SLOT][l.slot];
        const bool found = slot != NO_SLOT;
        const int sload_node = (sload_mask && found)
            ? leaf<int32_t>(a, K4_LANE, L_STORAGE_SYM)[L * K + slot] : 0;

        // ---- classify: FORK / PAUSE -------------------------------------------------
        const int cap = arg_int(a, K4_CAP);
        const int cond_cls = arg_ptr<int32_t>(a, K4_CLS)[clampll(sym2, 0, cap - 1)];
        const bool predictable = (cond_cls & arg_int(a, K4_PRED_MASK)) != 0;
        const bool cond_room = leaf<int32_t>(a, K4_LANE, L_COND_COUNT)[L] + 1 <= KC;
        const bool jumpi_sym_cond = running && op == OP_JUMPI && sym2 != 0 && sym1 == 0;
        const bool jumpi_host = jumpi_sym_cond && (predictable || !cond_room);
        const bool jumpi_fork = jumpi_sym_cond && !jumpi_host;
        const bool frozen_fork = st == ST_FORKING && op == OP_JUMPI && sym2 != 0
                                 && sym1 == 0 && cond_room && !predictable;
        const bool sload_cold = sload_mask && sym1 == 0
            && leaf<uint8_t>(a, K4_LANE, L_STORAGE_BASE_SYM)[L] && !found;
        const bool force_fork = jumpi_fork || sload_cold;

        // ---- classify: ESCAPE -------------------------------------------------------
        const bool sym_repr = flags & (OPF_SYM_OK | OPF_PLUMBING);
        const bool esc_always = running && (op == OP_STOP || op == OP_RETURN
                                            || op == OP_REVERT || op == OP_INVALID);
        const bool region = red[R_READS][l.slot] || red[R_COPY][l.slot] || red[R_MCOPY][l.slot];
        bool esc = any_sym && !sym_repr && !mstore_sym_val && !(sload_mask || sstore_mask);
        esc = esc || (running && (op == OP_JUMP || op == OP_JUMPI) && sym1 != 0);
        esc = esc || jumpi_host;
        esc = esc || (running && (op == OP_MSTORE || op == OP_MLOAD) && sym1 != 0);
        esc = esc || cdl_sym_off || mload_dirty;
        esc = esc || ((sload_mask || sstore_mask) && sym1 != 0);
        esc = esc || region;
        esc = esc || (running && symbolic_env && (op == OP_CALLDATACOPY || op == OP_SELFBALANCE));
        const bool force_escape = (esc || esc_always) && !force_fork;

        if (TEL) {
            // the where-chain of symstep.py:836-858: the last matching cause wins
            if (force_escape) {
                int cause = EC_HOST_OP;
                if (region) cause = EC_SYM_MEM_REGION;
                if ((sload_mask || sstore_mask) && sym1 != 0) cause = EC_SYM_STORAGE_KEY;
                if (mload_dirty) cause = EC_DIRTY_MLOAD;
                if ((running && (op == OP_MSTORE || op == OP_MLOAD) && sym1 != 0) || cdl_sym_off)
                    cause = EC_SYM_MEM_OFF;
                if (jumpi_host) cause = EC_DETECTOR_BRANCH;
                if (running && (op == OP_JUMP || op == OP_JUMPI) && sym1 != 0)
                    cause = EC_SYM_JUMP_DEST;
                if (esc_always) cause = EC_HALT;
                atomicAdd(&tel[T_CAUSE + cause], 1);
            }
            if (running) {
                atomicAdd(&tel[T_OP + OPF_OP_CLASS(flags)], 1);
                const int32_t* tag_pcs = arg_ptr<const int32_t>(a, K4_TEL_TAG_PCS);
                for (int k = 0; k < arg_int(a, K4_TEL_N_TAGS); ++k)
                    if (pc == tag_pcs[k]) atomicAdd(&tel[T_TAG + k], 1);
                // the fleet slot of the lane's seeding context
                const int n_ctx = arg_int(a, K4_TEL_N_CTX), n_fleet = arg_int(a, K4_TEL_N_FLEET);
                if (n_fleet > 0) {
                    const int ctx = leaf<int32_t>(a, K4_LANE, L_CTX_ID)[L];
                    const int fslot = arg_ptr<const int32_t>(a, K4_TEL_FLEET_SLOTS)[
                        clampll(ctx, 0, n_ctx - 1)];
                    if (fslot >= 0 && fslot < n_fleet) atomicAdd(&tel[T_FLEET + fslot], 1);
                }
            }
            if (sload_cold) atomicAdd(&tel[T_COLD], 1);
        }
        if (running) atomicAdd(&tel[T_RUNNING], 1);

        iscr(a, I_OP)[L] = op;
        iscr(a, I_SYM1)[L] = sym1;
        iscr(a, I_SYM2)[L] = sym2;
        iscr(a, I_PRE_SP)[L] = sp;
        iscr(a, I_PRE_PC)[L] = pc;
        iscr(a, I_MLOAD_NODE)[L] = mload_node;
        iscr(a, I_SLOAD_NODE)[L] = sload_node;
        iscr(a, I_VAR_CLASS)[L] = cdl_var ? V_CALLDATA_WORD : env_class;
        iscr(a, I_VAR_QUAL)[L] = cdl_var ? static_cast<int>(off_i) : 0;
        fscr(a, F_FORCE_ESCAPE)[L] = force_escape;
        fscr(a, F_FORCE_FORK)[L] = force_fork;
        fscr(a, F_WAS_RUNNING)[L] = running;
        fscr(a, F_JUMPI_FORK)[L] = jumpi_fork;
        fscr(a, F_FROZEN_FORK)[L] = frozen_fork;
        fscr(a, F_SLOAD_COLD)[L] = sload_cold;
        fscr(a, F_MSTORE_SYM_VAL)[L] = mstore_sym_val;
        fscr(a, F_MLOAD_CLEAN)[L] = mload_mask && mload_clean;
        fscr(a, F_ANY_SYM)[L] = any_sym;
        fscr(a, F_CDL_VAR)[L] = cdl_var;
        fscr(a, F_ENV_VAR_OP)[L] = env_var_op;
        fscr(a, F_SSTORE)[L] = sstore_mask;
    }
    __syncthreads();
    // the block's counts into the scheduler and the plane
    if (threadIdx.x == 0 && tel[T_RUNNING]) {
        add64(arg_ptr<long long>(a, K4_EXECUTED), tel[T_RUNNING]);
        if (TEL) add64(tel_counter(a, K4_TEL_OCCUPANCY), tel[T_RUNNING]);
    }
    if (TEL) {
        for (int i = threadIdx.x; i < T_RUNNING; i += blockDim.x) {
            if (!tel[i]) continue;
            long long* dst;
            if (i < T_CAUSE) dst = tel_counter(a, K4_TEL_OP_HIST) + (i - T_OP);
            else if (i < T_TAG) dst = tel_counter(a, K4_TEL_ESC_CAUSE) + (i - T_CAUSE);
            else if (i < T_FLEET) dst = tel_counter(a, K4_TEL_TAG_OCC) + (i - T_TAG);
            else if (i < T_COLD) dst = tel_counter(a, K4_TEL_FLEET_OCC) + (i - T_FLEET);
            else dst = tel_counter(a, K4_TEL_LIFECYCLE) + LC_COLD_SLOADS;
            add64(dst, tel[i]);
        }
    }
}

// ---- the folded allocations and the planes --------------------------------------------

// after K2: which lanes allocate which nodes, and the tile scans of the
// four allocations (CONST a, CONST b, result, env VAR)
__global__ void sym_alloc_count_kernel(Args a) {
    __shared__ unsigned long long buf[1024];
    const Lanes l = lanes_of(a);
    unsigned long long wants = 0;
    if (l.active) {
        const long long L = l.lane;
        const int32_t* optab = arg_ptr<const int32_t>(a, K4_OPTAB);
        const int op = iscr(a, I_OP)[L];
        const bool advanced = fscr(a, F_WAS_RUNNING)[L] && !fscr(a, F_FORCE_ESCAPE)[L]
            && !fscr(a, F_FORCE_FORK)[L] && leaf<int32_t>(a, K4_LANE, L_STATUS)[L] == ST_RUNNING;
        const bool sym_compute = advanced && fscr(a, F_ANY_SYM)[L]
                                 && (optab[4 * op + OPT_FLAGS] & OPF_SYM_OK);
        const int pops = optab[4 * op + OPT_POPS];
        const bool ca = sym_compute && iscr(a, I_SYM1)[L] == 0 && pops >= 1;
        const bool cb = sym_compute && iscr(a, I_SYM2)[L] == 0 && pops >= 2;
        const bool e = advanced && (fscr(a, F_ENV_VAR_OP)[L] || fscr(a, F_CDL_VAR)[L]);
        fscr(a, F_ADVANCED)[L] = advanced;
        fscr(a, F_WANT_CA)[L] = ca;
        fscr(a, F_WANT_CB)[L] = cb;
        fscr(a, F_WANT_R)[L] = sym_compute;
        fscr(a, F_WANT_E)[L] = e;
        wants = static_cast<unsigned long long>(ca) | static_cast<unsigned long long>(cb) << 16
                | static_cast<unsigned long long>(sym_compute) << 32
                | static_cast<unsigned long long>(e) << 48;
    }
    tile_scan(a, l, SC_CA, 4, wants, buf);
}

// the bump pointers of the four allocations, in K3's call order
__global__ void sym_alloc_seg_kernel(Args a) {
    __shared__ int buf[SEG_THREADS];
    for (int c = SC_CA; c <= SC_E; ++c) prefix_tiles(a, c, buf);
    __syncthreads();
    if (threadIdx.x != 0) return;
    const int nb = arg_int(a, K4_NB);
    const long long cap = a.v[K4_CAP], ccap = a.v[K4_AR_CCAP];
    int* n_ptr = arg_ptr<int>(a, K4_AR_N);
    int* nc_ptr = arg_ptr<int>(a, K4_AR_N_CONST);
    int* alloc = arg_ptr<int>(a, K4_ALLOC);
    long long nc = *nc_ptr, n = *n_ptr;
    alloc[AL_NC0] = static_cast<int>(nc);
    alloc[AL_N0] = static_cast<int>(n);
    arena_const_advance(&nc, &n, tile_pre(a, SC_CA)[nb], cap, ccap);
    alloc[AL_NC1] = static_cast<int>(nc);
    alloc[AL_N1] = static_cast<int>(n);
    arena_const_advance(&nc, &n, tile_pre(a, SC_CB)[nb], cap, ccap);
    alloc[AL_N2] = static_cast<int>(n);
    n = n + tile_pre(a, SC_R)[nb] < cap ? n + tile_pre(a, SC_R)[nb] : cap;
    alloc[AL_N3] = static_cast<int>(n);
    n = n + tile_pre(a, SC_E)[nb] < cap ? n + tile_pre(a, SC_E)[nb] : cap;
    *n_ptr = static_cast<int>(n);
    *nc_ptr = static_cast<int>(nc);
}

// one const allocation of the lane (rank r): its word into the pool, its
// CONST node; returns the node id (0 on overflow) and sets *ovf
__device__ int lane_const(const Args& a, const ArenaRef& ar, const Lanes& l, int r,
                          long long nc0, long long n0, const int32_t* word, bool* ovf) {
    const long long cid = nc0 + r;
    if (cid >= ar.ccap) {
        *ovf = true;
        return 0;
    }
    for (int i = l.sub; i < 16; i += l.g) ar.const_vals[cid * 16 + i] = word[i];
    const int id = arena_node_id(n0, r, ar.cap, ovf);
    if (!*ovf && l.leader)
        arena_put_node(ar, id, ARENA_CONST_TAG, 0, 0, 0, static_cast<int>(cid), 0, 0);
    return id;
}

// the lane's nodes, then the stack, memory and storage planes; the tile
// scan of escaped lanes; K4_GROUP threads a lane
template <bool TEL>
__global__ void sym_planes_kernel(Args a) {
    __shared__ int slot_min[MAX_LPB];
    __shared__ int n_ovf;
    __shared__ unsigned long long buf[1024];
    const Lanes l = lanes_of(a);
    const int S = arg_int(a, K4_S), M = arg_int(a, K4_M), K = arg_int(a, K4_K);
    if (l.leader) slot_min[l.slot] = NO_SLOT;
    if (threadIdx.x == 0) n_ovf = 0;
    __syncthreads();

    const long long L = l.active ? l.lane : 0;
    const int32_t* optab = arg_ptr<const int32_t>(a, K4_OPTAB);
    int32_t* status = leaf<int32_t>(a, K4_LANE, L_STATUS);
    int32_t* ss = leaf<int32_t>(a, K4_LANE, L_STACK_SYM) + L * S;
    int32_t* ms = leaf<int32_t>(a, K4_LANE, L_MEM_SYM) + L * M;
    const int op = iscr(a, I_OP)[L], sym1 = iscr(a, I_SYM1)[L], sym2 = iscr(a, I_SYM2)[L];
    const int pre_sp = iscr(a, I_PRE_SP)[L];
    const bool advanced = l.active && fscr(a, F_ADVANCED)[L];
    const int new_sp = leaf<int32_t>(a, K4_LANE, L_SP)[L];
    const bool is_dup = op >= 0x80 && op <= 0x8F;
    const bool is_swap = op >= 0x90 && op <= 0x9F;
    bool off_fits;
    const long long off_i = low32(wscr(a, W_A, L), &off_fits);

    if (l.active) {
        // ---- the four allocations (arena.py:105, 146, in symstep.py's order) ---------
        const ArenaRef ar = arena_of(a);
        const int* alloc = arg_ptr<const int>(a, K4_ALLOC);
        bool ovf_ca = false, ovf_cb = false, ovf_r = false, ovf_e = false;
        int ids_ca = 0, ids_cb = 0, ids_r = 0, ids_e = 0;
        if (fscr(a, F_WANT_CA)[L])
            ids_ca = lane_const(a, ar, l, grank(a, SC_CA, L), alloc[AL_NC0], alloc[AL_N0],
                                wscr(a, W_A, L), &ovf_ca);
        if (fscr(a, F_WANT_CB)[L])
            ids_cb = lane_const(a, ar, l, grank(a, SC_CB, L), alloc[AL_NC1], alloc[AL_N1],
                                wscr(a, W_B, L), &ovf_cb);
        const int node_a = sym1 != 0 ? sym1 : ids_ca;
        const int node_b = sym2 != 0 ? sym2 : ids_cb;
        if (fscr(a, F_WANT_R)[L]) {
            ids_r = arena_node_id(alloc[AL_N2], grank(a, SC_R, L), ar.cap, &ovf_r);
            if (!ovf_r && l.leader) {
                // the children's masks as K3 reads them: a CONST node this
                // step made has mask 0
                const int cls_a = sym1 == 0 && ids_ca != 0
                    ? 0 : ar.cls[arena_clamp(node_a, ar.cap - 1)];
                const int cls_b = sym2 == 0 && ids_cb != 0
                    ? 0 : ar.cls[arena_clamp(node_b, ar.cap - 1)];
                arena_put_node(ar, ids_r, op, node_a, node_b, 0, 0, iscr(a, I_PRE_PC)[L],
                               cls_a | cls_b | ar.cls[0]);
            }
        }
        if (fscr(a, F_WANT_E)[L]) {
            ids_e = arena_node_id(alloc[AL_N3], grank(a, SC_E, L), ar.cap, &ovf_e);
            const int var_class = iscr(a, I_VAR_CLASS)[L];
            if (!ovf_e && l.leader)
                arena_put_node(ar, ids_e, ARENA_VAR_TAG, 0, 0, 0, var_class,
                               iscr(a, I_VAR_QUAL)[L],
                               arena_node_cls(ar, ARENA_VAR_TAG, 0, 0, 0, var_class));
        }

        // ---- arena exhaustion kills the lane ---------------------------------------
        if (l.leader && (ovf_ca || ovf_cb || ovf_r || ovf_e)) {
            status[L] = ST_DEAD;
            if (TEL) atomicAdd(&n_ovf, 1);
        }

        // ---- stack plane: the produced node at the new top -------------------------
        if (advanced && l.leader && optab[4 * op + OPT_PUSHES] >= 1 && !is_swap) {
            int new_top;
            if (fscr(a, F_WANT_R)[L]) new_top = ids_r;
            else if (fscr(a, F_WANT_E)[L]) new_top = ids_e;
            else if (fscr(a, F_MLOAD_CLEAN)[L]) new_top = iscr(a, I_MLOAD_NODE)[L];
            else new_top = iscr(a, I_SLOAD_NODE)[L];
            const int dup_node = ss[clampll(pre_sp - clampll(op - 0x7F, 1, 16), 0, S - 1)];
            ss[clampll(new_sp - 1, 0, S - 1)] = is_dup ? dup_node : new_top;
        }

        // ---- storage plane: the slot of a concrete-key SSTORE ----------------------
        if (advanced && fscr(a, F_SSTORE)[L] && sym1 == 0) {
            const int slot = table_share(leaf<int32_t>(a, K4_LANE, L_STORAGE_KEYS) + L * K * 16,
                                         leaf<uint8_t>(a, K4_LANE, L_STORAGE_USED) + L * K, K,
                                         wscr(a, W_A, L), l.sub, l.g);
            if (slot != NO_SLOT) atomicMin(&slot_min[l.slot], slot);
        }
    }
    __syncthreads();

    if (advanced) {
        // slots above the new sp clear (after the top write, before a swap)
        for (int j = (new_sp < 0 ? 0 : new_sp) + l.sub; j < S; j += l.g) ss[j] = 0;
        // memory plane: a clamped cell keeps the last write (the largest j)
        const bool mstore_sym = fscr(a, F_MSTORE_SYM_VAL)[L];
        if (mstore_sym || (op == OP_MSTORE && sym1 == 0 && sym2 == 0))
            for (int j = l.sub; j < 32; j += l.g)
                if (off_i + j < M - 1 || j == 31)
                    ms[clampll(off_i + j, 0, M - 1)] = mstore_sym ? (sym2 << 5) + j : 0;
        if (l.leader) {
            if (op == OP_MSTORE8 && sym1 == 0 && sym2 == 0) ms[clampll(off_i, 0, M - 1)] = 0;
            const int slot = slot_min[l.slot];
            if (slot != NO_SLOT) {
                leaf<int32_t>(a, K4_LANE, L_STORAGE_SYM)[L * K + slot] = sym2;
                leaf<uint8_t>(a, K4_LANE, L_STORAGE_DIRTY)[L * K + slot] = 1;
            }
            if (op == OP_JUMPI) leaf<int32_t>(a, K4_LANE, L_BRANCHES)[L] += 1;
            if (op == OP_JUMP) leaf<int32_t>(a, K4_LANE, L_LAST_JUMP)[L] = iscr(a, I_PRE_PC)[L];
        }
    }
    // ---- fork marker ------------------------------------------------------------------
    if (l.active && l.leader && fscr(a, F_WAS_RUNNING)[L]) {
        if (fscr(a, F_JUMPI_FORK)[L]) leaf<int32_t>(a, K4_LANE, L_FORK_COND)[L] = sym2;
        else if (fscr(a, F_SLOAD_COLD)[L]) leaf<int32_t>(a, K4_LANE, L_FORK_COND)[L] = 0;
    }
    __syncthreads();
    if (advanced && is_swap && l.leader) {
        const long long ti = clampll(pre_sp - 1, 0, S - 1);
        const long long di = clampll(pre_sp - 1 - clampll(op - 0x8F, 1, 16), 0, S - 1);
        const int t = ss[ti], d = ss[di];
        ss[ti] = d;
        ss[di] = t;
    }
    const bool esc_now = l.active && *arg_ptr<uint8_t>(a, K4_ENABLED)
                         && status[L] == ST_ESCAPED;
    tile_scan(a, l, SC_ESC, 1, esc_now, buf);
    if (TEL && threadIdx.x == 0 && n_ovf)
        add64(tel_counter(a, K4_TEL_LIFECYCLE) + LC_OVERFLOW_KILLS, n_ovf);
}

// ---- escape buffering -----------------------------------------------------------------

// halted and host-owned lanes of segment d go to escape segment d while it
// has room: the counts and the rows each segment uses
template <bool TEL>
__global__ void sym_esc_seg_kernel(Args a) {
    __shared__ int buf[SEG_THREADS];
    prefix_tiles(a, SC_ESC, buf);
    __syncthreads();
    const int seg_esc = arg_int(a, K4_E) / arg_int(a, K4_D);
    const int32_t* esc_count = arg_ptr<const int32_t>(a, K4_ESC_COUNT);
    const int total = runs_scan(
        arg_int(a, K4_D),
        [&](long long s) {
            const int esc = seg_count(a, SC_ESC, s), room = seg_esc - esc_count[s];
            return room > 0 ? (esc < room ? esc : room) : 0;
        },
        [&](long long s, int excl, int v) {
            seg_row(a, SG_ECOUNT)[s] = esc_count[s];
            seg_row(a, SG_PUT)[s] = v;
            seg_row(a, SG_PUT_BASE)[s] = excl;
            seg_row(a, SG_ESC_USED)[s] = esc_count[s] + v;
        },
        buf);
    if (threadIdx.x == 0) {
        arg_ptr<int>(a, K4_NMOVES)[PH_ESC] = total;
        if (TEL) {
            long long* lifecycle = tel_counter(a, K4_TEL_LIFECYCLE);
            lifecycle[LC_ESC_BUFFERED] += total;
            lifecycle[LC_ESC_FROZEN] += tile_pre(a, SC_ESC)[arg_int(a, K4_NB)] - total;
        }
    }
}

// the escapes' moves (lane -> escape row); the tile scans of DEAD lanes
// (those freed by the moves included) and of forkers
__global__ void sym_esc_apply_kernel(Args a) {
    __shared__ unsigned long long buf[1024];
    const Lanes l = lanes_of(a);
    unsigned long long counts = 0;
    if (l.active) {
        const long long L = l.lane;
        const int s = L / l.seg_len;
        const int st = leaf<int32_t>(a, K4_LANE, L_STATUS)[L];
        const bool esc_now = *arg_ptr<uint8_t>(a, K4_ENABLED) && st == ST_ESCAPED;
        const int erank = esc_now ? seg_rank(a, SC_ESC, L) : 0;
        const bool put = esc_now && erank < seg_row(a, SG_PUT)[s];
        fscr(a, F_PUT)[L] = put;
        if (put)
            put_move(a, seg_row(a, SG_PUT_BASE)[s] + erank, K4_LANE, L, K4_ESC,
                     static_cast<long long>(s) * (arg_int(a, K4_E) / l.D)
                         + seg_row(a, SG_ECOUNT)[s] + erank,
                     false);
        const bool is_dead = st == ST_DEAD || put;
        const bool want = fscr(a, F_JUMPI_FORK)[L] || fscr(a, F_FROZEN_FORK)[L];
        counts = static_cast<unsigned long long>(is_dead)
                 | static_cast<unsigned long long>(want) << 16;
    }
    tile_scan(a, l, SC_DEAD, 2, counts, buf);
}

// ---- on-device JUMPI forking ----------------------------------------------------------

// a forker of segment d claims a DEAD lane of d, or goes to stack segment
// d, or to escape segment d: the counts, the final tops, the counters
template <bool TEL>
__global__ void sym_fork_seg_kernel(Args a) {
    __shared__ int buf[SEG_THREADS];
    __shared__ int sums[4];  // claims, pushes, spills, forkers
    if (threadIdx.x < 4) sums[threadIdx.x] = 0;
    prefix_tiles(a, SC_DEAD, buf);
    prefix_tiles(a, SC_WANT, buf);
    __syncthreads();
    const int D = arg_int(a, K4_D);
    const int seg_pool = arg_int(a, K4_P) / D, seg_esc = arg_int(a, K4_E) / D;
    const bool enabled = *arg_ptr<uint8_t>(a, K4_ENABLED);
    int32_t* stack_top = arg_ptr<int32_t>(a, K4_STACK_TOP);
    int32_t* esc_count = arg_ptr<int32_t>(a, K4_ESC_COUNT);
    struct Split { int have, push, spill, want; };
    auto split = [&](long long s) {
        Split out;
        out.want = seg_count(a, SC_WANT, s);
        const int dead = seg_count(a, SC_DEAD, s);
        out.have = out.want < dead ? out.want : dead;
        const int rest = enabled ? out.want - out.have : 0;
        const int room = seg_pool - stack_top[s];
        out.push = room > 0 ? (rest < room ? rest : room) : 0;
        const int eroom = seg_esc - seg_row(a, SG_ESC_USED)[s];
        out.spill = eroom > 0 ? (rest - out.push < eroom ? rest - out.push : eroom) : 0;
        return out;
    };
    const int total = runs_scan(
        D,
        [&](long long s) {
            const Split v = split(s);
            return v.have + v.push + v.spill;
        },
        [&](long long s, int excl, int act) {
            const Split v = split(s);
            const int top2 = stack_top[s];
            seg_row(a, SG_TOP2)[s] = top2;
            seg_row(a, SG_HAVE)[s] = v.have;
            seg_row(a, SG_PUSH)[s] = v.push;
            seg_row(a, SG_ACT)[s] = act;
            seg_row(a, SG_ACT_BASE)[s] = excl;
            stack_top[s] = top2 + v.push;
            esc_count[s] = seg_row(a, SG_ESC_USED)[s] + v.spill;
            atomicAdd(&sums[0], v.have);
            atomicAdd(&sums[1], v.push);
            atomicAdd(&sums[2], v.spill);
            atomicAdd(&sums[3], v.want);
        },
        buf);
    __syncthreads();
    if (threadIdx.x != 0) return;
    *arg_ptr<long long>(a, K4_PUSHES) += sums[1];
    *arg_ptr<long long>(a, K4_FORKS) += total;
    arg_ptr<int>(a, K4_NMOVES)[PH_FORK] = total;
    if (TEL) {
        long long* lifecycle = tel_counter(a, K4_TEL_LIFECYCLE);
        lifecycle[LC_FORK_WAITS] += sums[3] - total;
        lifecycle[LC_FORKS_CLAIMED] += sums[0];
        lifecycle[LC_FORKS_PUSHED] += sums[1];
        lifecycle[LC_FORKS_SPILLED] += sums[2];
    }
}

// the claimed DEAD lanes; each acting forker's row becomes the post-fork
// template (sp -= 2, gas charged, +cond appended, dead stack_sym slots
// cleared) and its move is listed; K4_GROUP threads a lane
template <bool TEL>
__global__ void sym_fork_apply_kernel(Args a) {
    __shared__ int counts[2];  // bad jump deaths, frozen forks revived
    const Lanes l = lanes_of(a);
    if (threadIdx.x < 2) counts[threadIdx.x] = 0;
    __syncthreads();
    if (l.active) {
        const long long L = l.lane;
        const int s = L / l.seg_len;
        const long long base = static_cast<long long>(s) * l.seg_len;
        if (l.leader && leaf<int32_t>(a, K4_LANE, L_STATUS)[L] == ST_DEAD) {
            const int dr = seg_rank(a, SC_DEAD, L);
            if (dr < seg_row(a, SG_HAVE)[s]) arg_ptr<int>(a, K4_DEAD_MAP)[base + dr] = L;
        }
        const bool frozen_fork = fscr(a, F_FROZEN_FORK)[L];
        const bool want = fscr(a, F_JUMPI_FORK)[L] || frozen_fork;
        const int fr = want ? seg_rank(a, SC_WANT, L) : 0;
        if (want && fr < seg_row(a, SG_ACT)[s]) {
            const int S = arg_int(a, K4_S), KC = arg_int(a, K4_KC), C = arg_int(a, K4_C);
            const int sp_fork = iscr(a, I_PRE_SP)[L] - 2;
            int32_t* ss = leaf<int32_t>(a, K4_LANE, L_STACK_SYM) + L * S;
            for (int j = (sp_fork < 0 ? 0 : sp_fork) + l.sub; j < S; j += l.g) ss[j] = 0;
            if (l.leader) {
                const int32_t* optab = arg_ptr<const int32_t>(a, K4_OPTAB);
                int32_t* ccount = leaf<int32_t>(a, K4_LANE, L_COND_COUNT) + L;
                const int count = static_cast<int>(clampll(*ccount, 0, KC - 1));
                leaf<int32_t>(a, K4_LANE, L_SP)[L] = sp_fork;
                leaf<long long>(a, K4_LANE, L_GAS_USED)[L] += optab[4 * iscr(a, I_OP)[L] + OPT_GAS];
                leaf<int32_t>(a, K4_LANE, L_CONDS)[L * KC + count] = iscr(a, I_SYM2)[L];
                *ccount += 1;
                leaf<int32_t>(a, K4_LANE, L_BRANCHES)[L] += 1;
                iscr(a, I_COUNT)[L] = count;
                bool off_fits;
                const long long off_i = low32(wscr(a, W_A, L), &off_fits);
                const bool dest_ok = off_fits && off_i < leaf<int32_t>(a, K4_LANE, L_CODE_LEN)[L]
                    && leaf<uint8_t>(a, K4_LANE, L_JUMPDEST)[L * C + clampll(off_i, 0, C - 1)];
                fscr(a, F_DEST_OK)[L] = dest_ok;
                const int have = seg_row(a, SG_HAVE)[s], push = seg_row(a, SG_PUSH)[s];
                const int m = seg_row(a, SG_ACT_BASE)[s] + fr;
                if (fr < have)
                    put_move(a, m, K4_LANE, L, K4_LANE, base + fr, true);
                else if (fr < have + push)
                    put_move(a, m, K4_LANE, L, K4_POOL,
                             static_cast<long long>(s) * (arg_int(a, K4_P) / l.D)
                                 + seg_row(a, SG_TOP2)[s] + fr - have,
                             false);
                else
                    put_move(a, m, K4_LANE, L, K4_ESC,
                             static_cast<long long>(s) * (arg_int(a, K4_E) / l.D)
                                 + seg_row(a, SG_ESC_USED)[s] + fr - have - push,
                             false);
                if (TEL && !dest_ok) atomicAdd(&counts[0], 1);
                if (TEL && frozen_fork) atomicAdd(&counts[1], 1);
            }
        }
    }
    if (!TEL) return;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long* lifecycle = tel_counter(a, K4_TEL_LIFECYCLE);
        if (counts[0]) add64(lifecycle + LC_BAD_JUMP_DEATHS, counts[0]);
        if (counts[1]) add64(lifecycle + LC_FROZEN_REVIVED, counts[1]);
    }
}

// ---- launchers ------------------------------------------------------------------------

namespace {

struct Geometry {
    int nb, lpb, wide, seg, moves;
};

// the launch geometry, or nb = 0 if the block is invalid
Geometry geometry(const Args& a) {
    Geometry g = {0, 0, 0, 0, 0};
    const long long B = a.v[K4_B], D = a.v[K4_D], lpb = a.v[K4_LPB], group = a.v[K4_GROUP];
    if (B <= 0 || D <= 0 || B % D || a.v[K4_P] % D || a.v[K4_E] % D) return g;
    if (lpb <= 0 || lpb > MAX_LPB || group <= 0 || lpb * group > 1024) return g;
    if (a.v[K4_NB] != (B + lpb - 1) / lpb || a.v[K4_N_ITEMS] <= 0) return g;
    g.nb = static_cast<int>(a.v[K4_NB]);
    g.lpb = static_cast<int>(lpb);
    g.wide = static_cast<int>(lpb * group);
    // the one-block launches: a thread per tile or segment, up to SEG_THREADS
    g.seg = block_threads(g.nb > D ? g.nb : D);
    if (g.seg > SEG_THREADS) g.seg = SEG_THREADS;
    g.moves = static_cast<int>(a.v[K4_N_ITEMS] * (B < MOVE_ROWS ? B : MOVE_ROWS));
    return g;
}

// launch one kernel; a non-zero status stops the sequence
#define K4_STEP(kernel, grid, threads)                        \
    do {                                                      \
        MTPU_LAUNCH(kernel, (grid), (threads), stream, a);    \
        const int rc = MTPU_LAUNCH_STATUS();                  \
        if (rc) return rc;                                    \
    } while (0)

template <bool TEL>
int launch_pre(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const Geometry g = geometry(a);
    if (!g.nb) return 1;  // cudaErrorInvalidValue
    K4_STEP(sym_seed_count_kernel<TEL>, g.nb, g.lpb);
    K4_STEP(sym_seed_seg_kernel<TEL>, 1, g.seg);
    K4_STEP(sym_seed_apply_kernel, g.nb, g.lpb);
    a.v[K4_PHASE] = PH_SEED;
    K4_STEP(sym_move_kernel<TEL>, g.moves, MOVE_THREADS);
    K4_STEP(sym_classify_kernel<TEL>, g.nb, g.wide);
    return 0;
}

template <bool TEL>
int launch_post(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const Geometry g = geometry(a);
    if (!g.nb) return 1;  // cudaErrorInvalidValue
    K4_STEP(sym_alloc_count_kernel, g.nb, g.lpb);
    K4_STEP(sym_alloc_seg_kernel, 1, g.seg);
    K4_STEP(sym_planes_kernel<TEL>, g.nb, g.wide);
    K4_STEP(sym_esc_seg_kernel<TEL>, 1, g.seg);
    K4_STEP(sym_esc_apply_kernel, g.nb, g.lpb);
    a.v[K4_PHASE] = PH_ESC;
    K4_STEP(sym_move_kernel<TEL>, g.moves, MOVE_THREADS);
    K4_STEP(sym_fork_seg_kernel<TEL>, 1, g.seg);
    K4_STEP(sym_fork_apply_kernel<TEL>, g.nb, g.wide);
    a.v[K4_PHASE] = PH_FORK;
    K4_STEP(sym_move_kernel<TEL>, g.moves, MOVE_THREADS);
    return 0;
}

template <bool TEL>
int preload() {
    return MTPU_PRELOAD(sym_seed_count_kernel<TEL>) | MTPU_PRELOAD(sym_seed_seg_kernel<TEL>)
           | MTPU_PRELOAD(sym_move_kernel<TEL>) | MTPU_PRELOAD(sym_classify_kernel<TEL>)
           | MTPU_PRELOAD(sym_planes_kernel<TEL>) | MTPU_PRELOAD(sym_esc_seg_kernel<TEL>)
           | MTPU_PRELOAD(sym_fork_seg_kernel<TEL>) | MTPU_PRELOAD(sym_fork_apply_kernel<TEL>);
}

}  // namespace

MTPU_EXPORT int mtpu_sym_pre(const long long* v, int n, void* stream) {
    return launch_pre<false>(v, n, stream);
}

MTPU_EXPORT int mtpu_sym_pre_tel(const long long* v, int n, void* stream) {
    return launch_pre<true>(v, n, stream);
}

MTPU_EXPORT int mtpu_sym_post(const long long* v, int n, void* stream) {
    return launch_post<false>(v, n, stream);
}

MTPU_EXPORT int mtpu_sym_post_tel(const long long* v, int n, void* stream) {
    return launch_post<true>(v, n, stream);
}

// load every kernel of this source (before a CUDA graph captures them)
MTPU_EXPORT int mtpu_sym_preload(const long long*, int, void*) {
    return preload<false>() | preload<true>() | MTPU_PRELOAD(sym_seed_apply_kernel)
           | MTPU_PRELOAD(sym_alloc_count_kernel) | MTPU_PRELOAD(sym_alloc_seg_kernel)
           | MTPU_PRELOAD(sym_esc_apply_kernel);
}
