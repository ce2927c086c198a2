// Kernel K10: state merging, one pass, kernel K3's allocations folded in.
//
// Replaces mythril_tpu/parallel/symstep.py:1057 `merge_pass` (jitted at
// frontier.py:462-469). Fork siblings reconverged at a join differ only in
// the sign of their last path condition and in what their arms wrote; a
// pass pairs them and collapses each pair into one lane. One host call
// (`mtpu_merge_run`) launches the whole pass; nothing in it reads back to
// the host. Its launches:
//
//   merge_hash    once: each lane's content hashes over the leaves a merge
//                 must find equal (weak, weak + memory planes, core), one
//                 block per lane, the leaf sums reduced in shared memory;
//                 block 0 zeroes the stats
//   per round (n_rounds strict, then n_rounds widened with a window table):
//   merge_pair    eligibility, the sort key (hash of the sign-stripped
//                 conds, cond count, last sign), a bitonic sort of (key,
//                 lane) (the stable argsort JAX takes: ties keep lane
//                 order), the round's roll, and the (fi, ti) pairs: up to
//                 1024 lanes one block sorting in shared memory; above, a
//                 key launch, a launch per stage of the network over the
//                 next power of two in global memory, and a pairs launch
//   merge_check   a block per pair: exact verification; in widened rounds
//                 the window gather, diff containment and word blendability;
//                 then the blend families' allocation requests and, per
//                 pair, how many entries each of the nine allocations wants
//   merge_alloc_seg  one block: the nine allocations' exclusive prefixes
//                 over the pairs, side by side, and their bump pointers in
//                 JAX's order (families memory windows, stack, storage; in
//                 each the true side's CONSTs, the false side's, the ITEs)
//   merge_nodes   a block per pair: its entries' ranks (the pair's prefix
//                 plus a block scan over its slots), the const words, CONST
//                 and ITE rows by arena.cuh's rules, ids and overflow flags;
//                 an ITE's child made this round is a CONST (class mask 0),
//                 so no block reads a row another block writes
//   merge_apply   a block per pair: a pair whose blend overflowed the arena
//                 is cancelled (its nodes stay allocated); else the survivor
//                 is rewritten, the partner retired, the stats counted
//   merge_pair (blocked key) and merge_blocked, once: the blocked-by
//                 accounting charges each unmerged core-equal pair to the
//                 first gate that refused it.
//
// The hashes are int64 wraparound arithmetic in JAX, so here unsigned 64-bit
// (signed overflow is undefined); uint32 leaves (held as int32) widen with
// zeros, int32 leaves with their sign, bool and byte leaves as 0..255.
// Bound: bytes (the hashed and compared rows, a few hundred KB per round at
// the default geometry); the sort and the per-pair blocks are small, so the
// pass is bound by its launches: 5 a round and 3 more, from one host call.
#include "arena.cuh"
#include "words.cuh"

namespace {

enum { MODE_STRICT = 0, MODE_WIDEN = 1, MODE_BLOCKED = 2 };
enum { FAMILY_MEM = 0, FAMILY_STACK = 1, FAMILY_STORAGE = 2 };
enum { ITE_OP = 0x0F, STATS_FIXED = 8, N_DEPTH = 6, MAX_WINS = 32 };
enum { N_ALLOCS = 9, KIND_CT = 0, KIND_CF = 1, KIND_ITE = 2, SEG_GROUP = 64 };
// merge_check's and merge_blocked's threads a pair: their row compares
// are their time
enum { CHECK_THREADS = 512 };
enum { K_U8 = 1, K_I32 = 4, K_U32 = 5 };  // how a leaf's element widens

constexpr unsigned long long H_PRIME = 1099511628211ULL;
constexpr unsigned long long H_MASK = (1ULL << 62) - 1;
constexpr unsigned long long SENTINEL = 0x7FFFFFFFFFFFFFFFULL;

// symstep.MERGE_WEAK_LEAVES, then MERGE_MEM_LEAVES, as (leaf, kind)
constexpr int N_HASHED = 16, N_WEAK = 14, N_CORE = 8;
__constant__ int HASHED[N_HASHED][2] = {
    {L_PC, K_I32}, {L_SP, K_I32}, {L_MSIZE, K_I32}, {L_CODE_LEN, K_I32},
    {L_RETDATA_LEN, K_I32}, {L_RETDATA, K_U8}, {L_STORAGE_KEYS, K_U32},
    {L_STORAGE_USED, K_U8}, {L_TSTORE_KEYS, K_U32}, {L_TSTORE_VALS, K_U32},
    {L_TSTORE_USED, K_U8}, {L_STORAGE_BASE_SYM, K_U8}, {L_SYMBOLIC_ENV, K_U8},
    {L_CTX_ID, K_I32}, {L_MEMORY, K_U8}, {L_MEM_SYM, K_I32}};
// symstep.MERGE_CORE_LEAVES as rows of HASHED
__constant__ int CORE[N_CORE] = {0, 1, 2, 3, 4, 5, 12, 13};

template <class T>
__device__ __forceinline__ T* lane_leaf(const Args& a, int leaf) {
    return arg_ptr<T>(a, K10_LANE + leaf);
}

__device__ __forceinline__ long long row_bytes(const Args& a, int leaf) {
    return a.v[K10_ROW_BYTES + leaf];
}

template <class T>
__device__ __forceinline__ T* fam(const Args& a, int family, int field) {
    return arg_ptr<T>(a, K10_FAM + family * N_FAM_FIELDS + field);
}

__device__ __forceinline__ int32_t* info(const Args& a, int row) {
    return arg_ptr<int32_t>(a, K10_INFO) + static_cast<long long>(row) * arg_int(a, K10_B);
}

__device__ __forceinline__ unsigned long long fold_mult(long long e) {
    return (static_cast<unsigned long long>(e) * 2654435761ULL + 0x9E3779B9ULL) | 1ULL;
}

__device__ __forceinline__ unsigned long long leaf_elem(const Args& a, int leaf,
                                                        int kind, long long lane,
                                                        long long e) {
    const char* row = lane_leaf<const char>(a, leaf) + lane * row_bytes(a, leaf);
    if (kind == K_U8) return reinterpret_cast<const uint8_t*>(row)[e];
    const int32_t v = reinterpret_cast<const int32_t*>(row)[e];
    return kind == K_U32 ? static_cast<unsigned long long>(static_cast<uint32_t>(v))
                         : static_cast<unsigned long long>(static_cast<long long>(v));
}

// this thread's share of "rows r1 and r2 of a leaf differ" (strided bytes)
__device__ bool rows_differ(const Args& a, int leaf, long long r1, long long r2) {
    const long long rb = row_bytes(a, leaf);
    const char* base = lane_leaf<const char>(a, leaf);
    bool d = false;
    if (rb % 4 == 0) {
        const int32_t* x = reinterpret_cast<const int32_t*>(base + r1 * rb);
        const int32_t* y = reinterpret_cast<const int32_t*>(base + r2 * rb);
        for (long long i = threadIdx.x; i < rb / 4; i += blockDim.x) d = d || x[i] != y[i];
    } else {
        for (long long i = threadIdx.x; i < rb; i += blockDim.x)
            d = d || base[r1 * rb + i] != base[r2 * rb + i];
    }
    return d;
}

// block-wide sum of one int per thread (every thread calls it)
__device__ int block_add(int v, int* cell) {
    if (threadIdx.x == 0) *cell = 0;
    __syncthreads();
    if (v) atomicAdd(cell, v);
    __syncthreads();
    const int total = *cell;
    __syncthreads();
    return total;
}

__device__ __forceinline__ bool block_any(bool v, int* cell) {
    return block_add(v ? 1 : 0, cell) != 0;
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// this thread's share of "the sign-stripped conds rows of two lanes differ"
__device__ bool conds_differ(const Args& a, int ti, int fi) {
    const int kc = arg_int(a, K10_KC);
    const int32_t* conds = lane_leaf<const int32_t>(a, L_CONDS);
    const int li_t = info(a, INFO_LAST_IDX)[ti], li_f = info(a, INFO_LAST_IDX)[fi];
    bool d = false;
    for (int j = threadIdx.x; j < kc; j += blockDim.x) {
        int vt = conds[static_cast<long long>(ti) * kc + j];
        int vf = conds[static_cast<long long>(fi) * kc + j];
        if (j == li_t) vt = iabs(vt);
        if (j == li_f) vf = iabs(vf);
        d = d || vt != vf;
    }
    return d;
}

__device__ __forceinline__ bool limbs_differ(const int32_t* x, const int32_t* y) {
    bool d = false;
    for (int i = 0; i < 16; ++i) d = d || x[i] != y[i];
    return d;
}

__device__ __forceinline__ void stat_add(const Args& a, int slot, long long v) {
    atomicAdd(reinterpret_cast<unsigned long long*>(arg_ptr<long long>(a, K10_STATS) + slot),
              static_cast<unsigned long long>(v));
}

}  // namespace

// ---- the lane hashes ---------------------------------------------------------------

__global__ void merge_hash_kernel(Args a) {
    __shared__ unsigned long long buf[256];
    __shared__ unsigned long long sums[N_HASHED];
    const long long lane = blockIdx.x;
    const int t = threadIdx.x;
    if (lane == 0)
        for (int i = t; i < STATS_FIXED + arg_int(a, K10_N_TAGS) + N_DEPTH; i += blockDim.x)
            arg_ptr<long long>(a, K10_STATS)[i] = 0;
    for (int h = 0; h < N_HASHED; ++h) {
        const int leaf = HASHED[h][0], kind = HASHED[h][1];
        const long long n = row_bytes(a, leaf) / (kind == K_U8 ? 1 : 4);
        unsigned long long s = 0;
        for (long long e = t; e < n; e += blockDim.x)
            s += leaf_elem(a, leaf, kind, lane, e) * fold_mult(e);
        buf[t] = s;
        __syncthreads();
        for (int half = blockDim.x / 2; half > 0; half >>= 1) {
            if (t < half) buf[t] += buf[t + half];
            __syncthreads();
        }
        if (t == 0) sums[h] = buf[0];
        __syncthreads();
    }
    if (t == 0) {
        unsigned long long weak = 0, core = 0;
        for (int h = 0; h < N_WEAK; ++h) weak = weak * H_PRIME + sums[h];
        unsigned long long full = weak;
        for (int h = N_WEAK; h < N_HASHED; ++h) full = full * H_PRIME + sums[h];
        for (int c = 0; c < N_CORE; ++c) core = core * H_PRIME + sums[CORE[c]];
        unsigned long long* hash = arg_ptr<unsigned long long>(a, K10_HASH);
        const long long B = a.v[K10_B];
        hash[lane] = weak;
        hash[B + lane] = full;
        hash[2 * B + lane] = core;
    }
}

// ---- pairing: the sort ---------------------------------------------------------------

namespace {

// lane t's eligibility, per-lane info and sort key (hash of the
// sign-stripped conds, cond count, last sign; SENTINEL if not eligible)
__device__ unsigned long long lane_key(const Args& a, int t) {
    const int B = arg_int(a, K10_B), KC = arg_int(a, K10_KC);
    const int mode = arg_int(a, K10_MODE);
    const int32_t* conds = lane_leaf<const int32_t>(a, L_CONDS) + static_cast<long long>(t) * KC;
    const int cc = lane_leaf<const int32_t>(a, L_COND_COUNT)[t];
    const int last_idx = cc - 1 < 0 ? 0 : (cc - 1 > KC - 1 ? KC - 1 : cc - 1);
    const int last = conds[last_idx];
    bool elig = lane_leaf<const int32_t>(a, L_STATUS)[t] == ST_RUNNING && cc > 0
                && last != 0 && lane_leaf<const int32_t>(a, L_FORK_COND)[t] == 0;
    int join = 0;
    if (mode == MODE_WIDEN) {
        const int pc = lane_leaf<const int32_t>(a, L_PC)[t];
        const int32_t* mem_pcs = arg_ptr<const int32_t>(a, K10_MEM_PCS);
        bool at = false;
        for (int j = arg_int(a, K10_J) - 1; j >= 0; --j)
            if (mem_pcs[j] == pc) { join = j; at = true; }
        elig = elig && at;
    }
    const unsigned long long* hash = arg_ptr<const unsigned long long>(a, K10_HASH);
    unsigned long long h;
    if (mode == MODE_BLOCKED) {
        h = hash[2 * B + t];
    } else {
        unsigned long long s = 0;
        for (int j = 0; j < KC; ++j) {
            const int v = j == last_idx ? iabs(conds[j]) : conds[j];
            s += static_cast<unsigned long long>(static_cast<long long>(v)) * fold_mult(j);
        }
        h = hash[(mode == MODE_WIDEN ? 0 : B) + t] * H_PRIME + s;
        h = h * H_PRIME + static_cast<unsigned long long>(cc);
    }
    info(a, INFO_LAST)[t] = last;
    info(a, INFO_CC)[t] = cc;
    info(a, INFO_LAST_IDX)[t] = last_idx;
    info(a, INFO_JOIN)[t] = join;
    arg_ptr<uint8_t>(a, K10_ELIG)[t] = elig;
    return elig ? ((h & H_MASK) << 1) | (last > 0 ? 1ULL : 0ULL) : SENTINEL;
}

// (key, lane) of p sorts after that of q: the stable order JAX's argsort gives
__device__ __forceinline__ bool after(unsigned long long kp, int ip, unsigned long long kq, int iq) {
    return kp > kq || (kp == kq && ip > iq);
}

// roll(perm, -shift), then (fi, ti) = adjacent positions
__device__ __forceinline__ void write_pair(const Args& a, const int* order, long long k) {
    const int B = arg_int(a, K10_B), shift = arg_int(a, K10_SHIFT);
    arg_ptr<int32_t>(a, K10_FI)[k] = order[(2 * k + shift) % B];
    arg_ptr<int32_t>(a, K10_TI)[k] = order[(2 * k + 1 + shift) % B];
}

}  // namespace

// up to 1024 lanes: one block, a thread per lane, a bitonic sort of
// (key, lane) in shared memory
__global__ void merge_pair_kernel(Args a) {
    __shared__ unsigned long long keys[1024];
    __shared__ int idx[1024];
    const int t = threadIdx.x, n = blockDim.x;
    const int B = arg_int(a, K10_B);
    keys[t] = t < B ? lane_key(a, t) : SENTINEL;
    idx[t] = t;  // pad lanes (t >= B) sort after every real lane
    __syncthreads();
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            const int p = t ^ j;
            if (p > t) {
                const bool ascending = (t & k) == 0;
                if (after(keys[t], idx[t], keys[p], idx[p]) == ascending) {
                    const unsigned long long kt = keys[t];
                    keys[t] = keys[p];
                    keys[p] = kt;
                    const int it = idx[t];
                    idx[t] = idx[p];
                    idx[p] = it;
                }
            }
            __syncthreads();
        }
    }
    for (int k = t; k < B / 2; k += n) write_pair(a, idx, k);
}

// more lanes: the same network over K10_SORT_N (a power of two) entries in
// global memory, a launch per stage; first the keys
__global__ void merge_keys_kernel(Args a) {
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= a.v[K10_SORT_N]) return;
    arg_ptr<unsigned long long>(a, K10_SORT_KEYS)[t] =
        t < arg_int(a, K10_B) ? lane_key(a, static_cast<int>(t)) : SENTINEL;
    arg_ptr<int>(a, K10_SORT_IDX)[t] = static_cast<int>(t);
}

// one stage (k, j) of the bitonic network: a thread per compared pair
__global__ void merge_sort_stage_kernel(Args a) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= a.v[K10_SORT_N] / 2) return;
    const long long k = a.v[K10_SORT_K], j = a.v[K10_SORT_J];
    const long long lo = (i / j) * 2 * j + i % j, hi = lo + j;
    unsigned long long* keys = arg_ptr<unsigned long long>(a, K10_SORT_KEYS);
    int* idx = arg_ptr<int>(a, K10_SORT_IDX);
    if (after(keys[lo], idx[lo], keys[hi], idx[hi]) == ((lo & k) == 0)) {
        const unsigned long long kt = keys[lo];
        keys[lo] = keys[hi];
        keys[hi] = kt;
        const int it = idx[lo];
        idx[lo] = idx[hi];
        idx[hi] = it;
    }
}

__global__ void merge_pairs_kernel(Args a) {
    const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (k < arg_int(a, K10_B) / 2) write_pair(a, arg_ptr<const int>(a, K10_SORT_IDX), k);
}

// ---- pairing: exact verification and the blend requests -----------------------------

__global__ void merge_check_kernel(Args a) {
    __shared__ int cell;
    __shared__ int wdiff[MAX_WINS];
    __shared__ int wants[N_ALLOCS];  // the pair's entries per allocation
    const int k = blockIdx.x, t = threadIdx.x;
    if (t < N_ALLOCS) wants[t] = 0;
    __syncthreads();
    const int ti = arg_ptr<const int32_t>(a, K10_TI)[k];
    const int fi = arg_ptr<const int32_t>(a, K10_FI)[k];
    const int mode = arg_int(a, K10_MODE);
    const int S = arg_int(a, K10_S), M = arg_int(a, K10_M), K = arg_int(a, K10_K);
    const uint8_t* elig = arg_ptr<const uint8_t>(a, K10_ELIG);
    const int last_t = info(a, INFO_LAST)[ti], last_f = info(a, INFO_LAST)[fi];
    bool ok = elig[ti] && elig[fi] && last_t > 0 && last_t == -last_f
              && info(a, INFO_CC)[ti] == info(a, INFO_CC)[fi];
    bool differs = conds_differ(a, ti, fi);
    const int n_equal = mode == MODE_WIDEN ? N_WEAK : N_HASHED;
    for (int h = 0; h < n_equal; ++h) differs = differs || rows_differ(a, HASHED[h][0], ti, fi);
    ok = ok && !block_any(differs, &cell);

    if (mode == MODE_WIDEN) {
        // every differing byte or mark inside a valid window of the join, and
        // each differing window one well-defined word on both sides
        const int W = arg_int(a, K10_W);
        const int32_t* wins = arg_ptr<const int32_t>(a, K10_MEM_WORDS)
                              + static_cast<long long>(info(a, INFO_JOIN)[ti]) * W;
        const uint8_t* mem = lane_leaf<const uint8_t>(a, L_MEMORY);
        const int32_t* msym = lane_leaf<const int32_t>(a, L_MEM_SYM);
        const long long rt = static_cast<long long>(ti) * M, rf = static_cast<long long>(fi) * M;
        if (t < W) wdiff[t] = 0;
        int all_diff = 0, win_diff = 0;
        for (int e = t; e < M; e += blockDim.x)
            all_diff += mem[rt + e] != mem[rf + e] || msym[rt + e] != msym[rf + e];
        __syncthreads();
        for (int c = t; c < W * 32; c += blockDim.x) {
            const int start = wins[c / 32], e = start + c % 32;
            if (start >= 0 && start + 32 <= M
                && (mem[rt + e] != mem[rf + e] || msym[rt + e] != msym[rf + e])) {
                ++win_diff;
                atomicAdd(&wdiff[c / 32], 1);
            }
        }
        const int n_all = block_add(all_diff, &cell);
        const bool contained = n_all == block_add(win_diff, &cell);
        // the per-window word views (cells gathered at clamped offsets)
        bool all0_t = true, all0_f = true, clean_t = true, clean_f = true;
        int first_t = 0, first_f = 0, start = -1;
        bool live = false;
        if (t < W) {
            start = wins[t];
            live = wdiff[t] > 0 && start >= 0 && start + 32 <= M;
            auto cell_at = [&](long long row, int j) {
                const long long e = start + j;
                return msym[row + (e < 0 ? 0 : (e > M - 1 ? M - 1 : e))];
            };
            first_t = cell_at(rt, 0);
            first_f = cell_at(rf, 0);
            for (int j = 0; j < 32; ++j) {
                const int ct = cell_at(rt, j), cf = cell_at(rf, j);
                all0_t = all0_t && ct == 0;
                all0_f = all0_f && cf == 0;
                clean_t = clean_t && ct == first_t + j;
                clean_f = clean_f && cf == first_f + j;
            }
            clean_t = clean_t && first_t != 0 && (first_t & 31) == 0;
            clean_f = clean_f && first_f != 0 && (first_f & 31) == 0;
        }
        const bool blendable = (all0_t || clean_t) && (all0_f || clean_f);
        ok = ok && contained && !block_any(live && !blendable, &cell);
        if (t < W) {
            const long long e = static_cast<long long>(k) * W + t;
            const bool need = live && ok;
            fam<uint8_t>(a, FAMILY_MEM, FAM_WANT_CT)[e] = need && all0_t;
            fam<uint8_t>(a, FAMILY_MEM, FAM_WANT_CF)[e] = need && all0_f;
            fam<uint8_t>(a, FAMILY_MEM, FAM_WANT_ITE)[e] = need;
            fam<int32_t>(a, FAMILY_MEM, FAM_PRE_T)[e] = all0_t ? 0 : first_t >> 5;
            fam<int32_t>(a, FAMILY_MEM, FAM_PRE_F)[e] = all0_f ? 0 : first_f >> 5;
            fam<int32_t>(a, FAMILY_MEM, FAM_COND)[e] = last_t;
            if (need) {
                if (all0_t) atomicAdd(&wants[KIND_CT], 1);
                if (all0_f) atomicAdd(&wants[KIND_CF], 1);
                atomicAdd(&wants[KIND_ITE], 1);
            }
            if (need && all0_t)
                limbs16_from_be(mem + rt + start, fam<int32_t>(a, FAMILY_MEM, FAM_VALS_T) + 16 * e);
            if (need && all0_f)
                limbs16_from_be(mem + rf + start, fam<int32_t>(a, FAMILY_MEM, FAM_VALS_F) + 16 * e);
        }
    }
    if (t == 0) arg_ptr<uint8_t>(a, K10_OK)[k] = ok;

    // the stack and storage slots that differ: blended through ITE nodes
    const int sp_t = lane_leaf<const int32_t>(a, L_SP)[ti];
    for (int family = FAMILY_STACK; family <= FAMILY_STORAGE; ++family) {
        const bool stack = family == FAMILY_STACK;
        const int width = stack ? S : K;
        const int32_t* sym = lane_leaf<const int32_t>(a, stack ? L_STACK_SYM : L_STORAGE_SYM);
        const int32_t* conc = lane_leaf<const int32_t>(a, stack ? L_STACK : L_STORAGE_VALS);
        const uint8_t* used = lane_leaf<const uint8_t>(a, L_STORAGE_USED);
        for (int j = t; j < width; j += blockDim.x) {
            const long long st = static_cast<long long>(ti) * width + j;
            const long long sf = static_cast<long long>(fi) * width + j;
            const int sym_t = sym[st], sym_f = sym[sf];
            const bool in_use = stack ? j < sp_t : used[st] != 0;
            const bool diff = ok && in_use
                && (sym_t != sym_f
                    || (sym_t == 0 && sym_f == 0 && limbs_differ(conc + 16 * st, conc + 16 * sf)));
            const long long e = static_cast<long long>(k) * width + j;
            fam<uint8_t>(a, family, FAM_WANT_CT)[e] = diff && sym_t == 0;
            fam<uint8_t>(a, family, FAM_WANT_CF)[e] = diff && sym_f == 0;
            fam<uint8_t>(a, family, FAM_WANT_ITE)[e] = diff;
            fam<int32_t>(a, family, FAM_PRE_T)[e] = sym_t;
            fam<int32_t>(a, family, FAM_PRE_F)[e] = sym_f;
            fam<int32_t>(a, family, FAM_COND)[e] = last_t;
            if (diff) {
                if (sym_t == 0) atomicAdd(&wants[family * 3 + KIND_CT], 1);
                if (sym_f == 0) atomicAdd(&wants[family * 3 + KIND_CF], 1);
                atomicAdd(&wants[family * 3 + KIND_ITE], 1);
            }
            for (int i = 0; diff && i < 16; ++i) {
                fam<int32_t>(a, family, FAM_VALS_T)[16 * e + i] = conc[16 * st + i];
                fam<int32_t>(a, family, FAM_VALS_F)[16 * e + i] = conc[16 * sf + i];
            }
        }
    }
    __syncthreads();
    if (t < N_ALLOCS) arg_ptr<int32_t>(a, K10_ACNT)[static_cast<long long>(t) * (arg_int(a, K10_B) / 2) + k] = wants[t];
}

// ---- the blends' allocations (K3 folded in) ---------------------------------------------

namespace {

__device__ __forceinline__ ArenaRef merge_arena(const Args& a) {
    return {arg_ptr<int32_t>(a, K10_AR_OP), arg_ptr<int32_t>(a, K10_AR_A),
            arg_ptr<int32_t>(a, K10_AR_B), arg_ptr<int32_t>(a, K10_AR_C),
            arg_ptr<int32_t>(a, K10_AR_IMM), arg_ptr<int32_t>(a, K10_AR_IMM2),
            arg_ptr<int32_t>(a, K10_AR_CLS), arg_ptr<int32_t>(a, K10_AR_CONST),
            a.v[K10_AR_CAP], a.v[K10_AR_CCAP]};
}

__device__ __forceinline__ int family_width(const Args& a, int family) {
    return family == FAMILY_MEM ? arg_int(a, K10_W)
                                : (family == FAMILY_STACK ? arg_int(a, K10_S) : arg_int(a, K10_K));
}

// the const allocation's entry of rank r (bump pointers base[0] nodes,
// base[1] consts): its word into the pool, its CONST node; returns the node
// id, 0 with *ovf set when the pool or the arena is full
__device__ int blend_const(const ArenaRef& ar, const int32_t* base, long long r,
                           const int32_t* word, bool* ovf) {
    const long long cid = base[1] + r;
    if (cid >= ar.ccap) {
        *ovf = true;
        return 0;
    }
    for (int i = 0; i < 16; ++i) ar.const_vals[cid * 16 + i] = word[i];
    const int id = arena_node_id(base[0], r, ar.cap, ovf);
    if (!*ovf) arena_put_node(ar, id, ARENA_CONST_TAG, 0, 0, 0, static_cast<int>(cid), 0, 0);
    return id;
}

}  // namespace

// one block of N_ALLOCS * SEG_GROUP threads: the nine allocations'
// exclusive prefixes over the pairs side by side (SEG_GROUP threads each,
// a contiguous run of pairs a thread), then the bump pointers in K3's call
// order
__global__ void merge_alloc_seg_kernel(Args a) {
    __shared__ int buf[N_ALLOCS * SEG_GROUP];
    __shared__ int totals[N_ALLOCS];
    const int t = threadIdx.x, al = t / SEG_GROUP, g = t % SEG_GROUP;
    const long long half = arg_int(a, K10_B) / 2;
    const int32_t* cnt = arg_ptr<const int32_t>(a, K10_ACNT) + al * half;
    int32_t* pre = arg_ptr<int32_t>(a, K10_APRE) + al * half;
    const long long per = (half + SEG_GROUP - 1) / SEG_GROUP;
    const long long lo = g * per < half ? g * per : half;
    const long long hi = lo + per < half ? lo + per : half;
    int count = 0;
    for (long long i = lo; i < hi; ++i) count += cnt[i];
    buf[t] = count;
    __syncthreads();
    for (int offset = 1; offset < SEG_GROUP; offset <<= 1) {
        const int add = g >= offset ? buf[t - offset] : 0;
        __syncthreads();
        buf[t] += add;
        __syncthreads();
    }
    int excl = buf[t] - count;
    for (long long i = lo; i < hi; ++i) {
        pre[i] = excl;
        excl += cnt[i];
    }
    if (g == SEG_GROUP - 1) totals[al] = buf[t];
    __syncthreads();
    if (threadIdx.x != 0) return;
    const long long cap = a.v[K10_AR_CAP], ccap = a.v[K10_AR_CCAP];
    int* n_ptr = arg_ptr<int>(a, K10_AR_N);
    int* nc_ptr = arg_ptr<int>(a, K10_AR_N_CONST);
    int32_t* base = arg_ptr<int32_t>(a, K10_ABASE);
    long long n = *n_ptr, nc = *nc_ptr;
    for (int family = FAMILY_MEM; family <= FAMILY_STORAGE; ++family) {
        for (int kind = KIND_CT; kind <= KIND_CF; ++kind) {
            base[2 * (family * 3 + kind)] = static_cast<int>(n);
            base[2 * (family * 3 + kind) + 1] = static_cast<int>(nc);
            arena_const_advance(&nc, &n, totals[family * 3 + kind], cap, ccap);
        }
        base[2 * (family * 3 + KIND_ITE)] = static_cast<int>(n);
        n = n + totals[family * 3 + KIND_ITE] < cap ? n + totals[family * 3 + KIND_ITE] : cap;
    }
    *n_ptr = static_cast<int>(n);
    *nc_ptr = static_cast<int>(nc);
}

// a block per pair: the CONST nodes for the survivor's and the partner's
// concrete words, the ITE operands (the clean word's / the slot's node,
// else the new CONST), the ITE rows; ids in JAX's order
__global__ void merge_nodes_kernel(Args a) {
    __shared__ unsigned long long buf[1024];
    const int k = blockIdx.x;
    const long long half = arg_int(a, K10_B) / 2;
    const ArenaRef ar = merge_arena(a);
    const int32_t* pre = arg_ptr<const int32_t>(a, K10_APRE);
    const int32_t* base = arg_ptr<const int32_t>(a, K10_ABASE);
    const bool widen = arg_int(a, K10_MODE) == MODE_WIDEN;
    for (int family = widen ? FAMILY_MEM : FAMILY_STACK; family <= FAMILY_STORAGE; ++family) {
        const long long width = family_width(a, family);
        const long long per = (width + blockDim.x - 1) / blockDim.x;
        const long long lo = threadIdx.x * per < width ? threadIdx.x * per : width;
        const long long hi = lo + per < width ? lo + per : width;
        const long long e0 = k * width;
        const uint8_t* want_ct = fam<const uint8_t>(a, family, FAM_WANT_CT) + e0;
        const uint8_t* want_cf = fam<const uint8_t>(a, family, FAM_WANT_CF) + e0;
        const uint8_t* want_ite = fam<const uint8_t>(a, family, FAM_WANT_ITE) + e0;
        // this thread's ranks: three 16-bit counts in one scan (a pair has
        // far fewer than 65,536 slots)
        unsigned long long mine = 0, total;
        for (long long j = lo; j < hi; ++j)
            mine += want_ct[j] | static_cast<unsigned long long>(want_cf[j]) << 16
                    | static_cast<unsigned long long>(want_ite[j]) << 32;
        const unsigned long long excl = block_exclusive_scan(mine, buf, &total);
        const int32_t* fpre = pre + family * 3 * half + k;
        long long r_ct = (excl & 0xFFFF) + fpre[KIND_CT * half];
        long long r_cf = ((excl >> 16) & 0xFFFF) + fpre[KIND_CF * half];
        long long r_ite = ((excl >> 32) & 0xFFFF) + fpre[KIND_ITE * half];
        const int32_t* fbase = base + 2 * family * 3;
        for (long long j = lo; j < hi; ++j) {
            const long long e = e0 + j;
            bool ovf_ct = false, ovf_cf = false, ovf_ite = false;
            const int id_ct = want_ct[j] ? blend_const(ar, fbase + 2 * KIND_CT, r_ct++,
                                                       fam<const int32_t>(a, family, FAM_VALS_T) + 16 * e,
                                                       &ovf_ct) : 0;
            const int id_cf = want_cf[j] ? blend_const(ar, fbase + 2 * KIND_CF, r_cf++,
                                                       fam<const int32_t>(a, family, FAM_VALS_F) + 16 * e,
                                                       &ovf_cf) : 0;
            const int pre_t = fam<const int32_t>(a, family, FAM_PRE_T)[e];
            const int pre_f = fam<const int32_t>(a, family, FAM_PRE_F)[e];
            const int node_t = pre_t != 0 ? pre_t : id_ct;
            const int node_f = pre_f != 0 ? pre_f : id_cf;
            int id_ite = 0;
            if (want_ite[j]) {
                id_ite = arena_node_id(fbase[2 * KIND_ITE], r_ite++, ar.cap, &ovf_ite);
                if (!ovf_ite) {
                    // the children's masks as K3 reads them: a CONST made
                    // this round has mask 0, any other child is older
                    const int cond = fam<const int32_t>(a, family, FAM_COND)[e];
                    const int cls_t = pre_t == 0 && id_ct != 0 ? 0 : ar.cls[arena_clamp(node_t, ar.cap - 1)];
                    const int cls_f = pre_f == 0 && id_cf != 0 ? 0 : ar.cls[arena_clamp(node_f, ar.cap - 1)];
                    arena_put_node(ar, id_ite, ITE_OP, cond, node_t, node_f, 0, 0,
                                   ar.cls[arena_clamp(cond, ar.cap - 1)] | cls_t | cls_f);
                }
            }
            fam<int32_t>(a, family, FAM_IDS_CT)[e] = id_ct;
            fam<int32_t>(a, family, FAM_IDS_CF)[e] = id_cf;
            fam<int32_t>(a, family, FAM_IDS_ITE)[e] = id_ite;
            fam<uint8_t>(a, family, FAM_OVF_CT)[e] = ovf_ct;
            fam<uint8_t>(a, family, FAM_OVF_CF)[e] = ovf_cf;
            fam<uint8_t>(a, family, FAM_OVF_ITE)[e] = ovf_ite;
            fam<int32_t>(a, family, FAM_NODE_T)[e] = node_t;
            fam<int32_t>(a, family, FAM_NODE_F)[e] = node_f;
        }
    }
}

// ---- apply: rewrite the survivor, retire the partner -----------------------------------

__global__ void merge_apply_kernel(Args a) {
    __shared__ int cell;
    const int k = blockIdx.x, t = threadIdx.x;
    const int ti = arg_ptr<const int32_t>(a, K10_TI)[k];
    const int fi = arg_ptr<const int32_t>(a, K10_FI)[k];
    const bool widen = arg_int(a, K10_MODE) == MODE_WIDEN;
    const int S = arg_int(a, K10_S), M = arg_int(a, K10_M), K = arg_int(a, K10_K);
    const int W = arg_int(a, K10_W), KC = arg_int(a, K10_KC);
    const int widths[3] = {widen ? W : 0, S, K};
    bool ovf = false;
    for (int family = 0; family < 3; ++family)
        for (int j = t; j < widths[family]; j += blockDim.x) {
            const long long e = static_cast<long long>(k) * widths[family] + j;
            ovf = ovf || fam<const uint8_t>(a, family, FAM_OVF_CT)[e]
                  || fam<const uint8_t>(a, family, FAM_OVF_CF)[e]
                  || fam<const uint8_t>(a, family, FAM_OVF_ITE)[e];
        }
    // an arena overflow mid-blend cancels the pair (nodes stay allocated)
    const bool merged = arg_ptr<const uint8_t>(a, K10_OK)[k] && !block_any(ovf, &cell);
    if (!merged) return;

    int depth = 0, blends = 0;
    for (int family = FAMILY_STACK; family <= FAMILY_STORAGE; ++family) {
        const int width = widths[family];
        int32_t* sym = lane_leaf<int32_t>(a, family == FAMILY_STACK ? L_STACK_SYM : L_STORAGE_SYM);
        for (int j = t; j < width; j += blockDim.x) {
            const long long e = static_cast<long long>(k) * width + j;
            if (fam<const uint8_t>(a, family, FAM_WANT_ITE)[e]) {
                sym[static_cast<long long>(ti) * width + j] = fam<const int32_t>(a, family, FAM_IDS_ITE)[e];
                ++depth;
            }
        }
    }
    uint8_t* dirty = lane_leaf<uint8_t>(a, L_STORAGE_DIRTY);
    for (int j = t; j < K; j += blockDim.x)
        dirty[static_cast<long long>(ti) * K + j] |= dirty[static_cast<long long>(fi) * K + j];
    if (widen) {
        const int32_t* wins = arg_ptr<const int32_t>(a, K10_MEM_WORDS)
                              + static_cast<long long>(info(a, INFO_JOIN)[ti]) * W;
        int32_t* msym = lane_leaf<int32_t>(a, L_MEM_SYM) + static_cast<long long>(ti) * M;
        for (int c = t; c < W * 32; c += blockDim.x) {
            const long long e = static_cast<long long>(k) * W + c / 32;
            if (!fam<const uint8_t>(a, FAMILY_MEM, FAM_WANT_ITE)[e]) continue;
            msym[wins[c / 32] + c % 32] = (fam<const int32_t>(a, FAMILY_MEM, FAM_IDS_ITE)[e] << 5) + c % 32;
            if (c % 32 == 0) { ++depth; ++blends; }
        }
    }
    depth = block_add(depth, &cell);
    blends = block_add(blends, &cell);
    if (t != 0) return;
    int32_t* cond_count = lane_leaf<int32_t>(a, L_COND_COUNT);
    lane_leaf<int32_t>(a, L_CONDS)[static_cast<long long>(ti) * KC + info(a, INFO_LAST_IDX)[ti]] = 0;
    cond_count[ti] = info(a, INFO_CC)[ti] - 1;
    int32_t* branches = lane_leaf<int32_t>(a, L_BRANCHES);
    if (branches[fi] > branches[ti]) branches[ti] = branches[fi];
    long long* gas = lane_leaf<long long>(a, L_GAS_USED);
    if (gas[fi] > gas[ti]) gas[ti] = gas[fi];
    lane_leaf<int32_t>(a, L_STATUS)[fi] = ST_DEAD;

    stat_add(a, 0, 1);
    stat_add(a, 1, depth);
    if (blends) stat_add(a, 2, 1);
    const int n_tags = arg_int(a, K10_N_TAGS);
    const int pc = lane_leaf<const int32_t>(a, L_PC)[ti];
    const int32_t* merge_pcs = arg_ptr<const int32_t>(a, K10_MERGE_PCS);
    for (int i = 0; i < n_tags; ++i)
        if (merge_pcs[i] == pc) stat_add(a, STATS_FIXED + i, 1);
    stat_add(a, STATS_FIXED + n_tags + (depth >= 8 ? 5 : (depth >= 4 ? 4 : depth)), 1);
}

// ---- blocked-by accounting ----------------------------------------------------------

__global__ void merge_blocked_kernel(Args a) {
    __shared__ int cell;
    const int k = blockIdx.x;
    const int ti = arg_ptr<const int32_t>(a, K10_TI)[k];
    const int fi = arg_ptr<const int32_t>(a, K10_FI)[k];
    bool core = false;
    for (int c = 0; c < N_CORE; ++c) core = core || rows_differ(a, HASHED[CORE[c]][0], ti, fi);
    const bool core_diff = block_any(core, &cell);
    const bool conds_diff = block_any(conds_differ(a, ti, fi), &cell);
    const bool keys_diff = block_any(rows_differ(a, L_STORAGE_KEYS, ti, fi)
                                     || rows_differ(a, L_STORAGE_USED, ti, fi)
                                     || rows_differ(a, L_STORAGE_BASE_SYM, ti, fi), &cell);
    const bool ts_diff = block_any(rows_differ(a, L_TSTORE_KEYS, ti, fi)
                                   || rows_differ(a, L_TSTORE_VALS, ti, fi)
                                   || rows_differ(a, L_TSTORE_USED, ti, fi), &cell);
    const bool msym_diff = block_any(rows_differ(a, L_MEM_SYM, ti, fi), &cell);
    const bool mem_diff = block_any(rows_differ(a, L_MEMORY, ti, fi), &cell);
    if (threadIdx.x != 0) return;
    const uint8_t* elig = arg_ptr<const uint8_t>(a, K10_ELIG);
    const int last_t = info(a, INFO_LAST)[ti], last_f = info(a, INFO_LAST)[fi];
    if (!(elig[ti] && elig[fi]) || core_diff) return;
    const bool sib = last_t > 0 && last_t == -last_f
                     && info(a, INFO_CC)[ti] == info(a, INFO_CC)[fi] && !conds_diff;
    // gates in symstep.MERGE_BLOCKED_LABELS order at stats[3..7]
    int slot;
    if (!sib) slot = 7;
    else if (keys_diff) slot = 5;
    else if (ts_diff) slot = 6;
    else if (msym_diff) slot = 4;
    else if (mem_diff) slot = 3;
    else return;
    stat_add(a, slot, 1);
}

namespace {

int launch(void (*kernel)(Args), const Args& a, void* stream, long long grid, int threads) {
    if (a.v[K10_B] < 2 || grid <= 0) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(kernel, static_cast<unsigned>(grid), threads, stream, a);
    return MTPU_LAUNCH_STATUS();
}

// the round's pairs: one block up to 1024 lanes, else the sort over global
// memory, a launch per stage
int pair(Args a, void* stream) {
    const long long B = a.v[K10_B];
    if (B <= 1024) return launch(merge_pair_kernel, a, stream, 1, block_threads(B));
    const long long size = a.v[K10_SORT_N];
    if (size < B || (size & (size - 1))) return 1;  // cudaErrorInvalidValue
    int rc = launch(merge_keys_kernel, a, stream, (size + 255) / 256, 256);
    for (long long k = 2; k <= size && !rc; k <<= 1)
        for (long long j = k >> 1; j > 0 && !rc; j >>= 1) {
            a.v[K10_SORT_K] = k;
            a.v[K10_SORT_J] = j;
            rc = launch(merge_sort_stage_kernel, a, stream, (size / 2 + 127) / 128, 128);
        }
    return rc ? rc : launch(merge_pairs_kernel, a, stream, (B / 2 + 255) / 256, 256);
}

}  // namespace

// one round's pairing alone (its tests drive the sort)
MTPU_EXPORT int mtpu_merge_pair(const long long* v, int n, void* stream) {
    return pair(mtpu_pack(v, n), stream);
}

// the whole pass: K10_ROUNDS strict rounds, as many widened ones with a
// window table (K10_J > 0), then the blocked-by accounting
MTPU_EXPORT int mtpu_merge_run(const long long* v, int n, void* stream) {
    Args a = mtpu_pack(v, n);
    const long long pairs = a.v[K10_B] / 2;
    if (a.v[K10_W] > MAX_WINS || a.v[K10_ROUNDS] < 0) return 1;  // cudaErrorInvalidValue
    int rc = launch(merge_hash_kernel, a, stream, a.v[K10_B], 256);
    for (int mode = MODE_STRICT; mode <= (a.v[K10_J] > 0 ? MODE_WIDEN : MODE_STRICT); ++mode)
        for (long long round = 0; round < a.v[K10_ROUNDS] && !rc; ++round) {
            a.v[K10_MODE] = mode;
            a.v[K10_SHIFT] = round % 2;
            rc = pair(a, stream);
            if (!rc) rc = launch(merge_check_kernel, a, stream, pairs, CHECK_THREADS);
            if (!rc) rc = launch(merge_alloc_seg_kernel, a, stream, 1, N_ALLOCS * SEG_GROUP);
            if (!rc) rc = launch(merge_nodes_kernel, a, stream, pairs, 256);
            if (!rc) rc = launch(merge_apply_kernel, a, stream, pairs, 128);
        }
    a.v[K10_MODE] = MODE_BLOCKED;
    a.v[K10_SHIFT] = 0;
    if (!rc) rc = pair(a, stream);
    return rc ? rc : launch(merge_blocked_kernel, a, stream, pairs, CHECK_THREADS);
}
