// Kernel K6: the drain's row programs. Three entries:
//
//   mtpu_row_maxima  replaces frontier.py:191 `_row_maxima`: int64[4] =
//                    max msize, sp, used storage slots and cond_count over
//                    the selected rows. maxima.cuh's grid, shared with K5:
//                    a group of lanes a row (64 rows a block at 64 storage
//                    slots), four maxima a block to K6_PARTIAL, then one
//                    block combining them;
//   mtpu_pack_rows   replaces frontier.py:156 `_pack_rows`: a group of 8
//                    threads for each (row, item) pair, item 0 the row's
//                    eight scalar words and gas, items 1-10 its runs, each
//                    copied with the widest access its ends and length allow
//                    (common.cuh `copy_span`), into three flat blocks at
//                    exactly the offsets the host's drain_unpack reads:
//                      int32: pc, sp, msize, code_len, cond_count, ctx_id,
//                             last_jump, branches (one word a row each),
//                             stack[:sp_b], storage_keys[:st_b],
//                             storage_vals[:st_b] (16 limbs a slot, the
//                             uint32 limbs as their bit patterns),
//                             stack_sym[:sp_b], mem_sym[:mem_b],
//                             storage_sym[:st_b], conds[:conds_w]
//                      uint8: memory[:mem_b], storage_used[:st_b],
//                             storage_dirty[:st_b]
//                      int64: gas_used
//   mtpu_reset_esc   replaces frontier.py:248 `_reset_esc`: one block, a
//                    thread a segment, zeroes the escape counts of a
//                    scheduler (K6_ESC_SEGMENTS of them).
//
// The index may repeat index[0] (power-of-two padding) or hold zeros
// (padding of an escape drain): the maxima and the pack only read, so
// duplicates are harmless; out-of-range entries clamp, as JAX's gather does.
//
// Bound: bytes (each packed byte read once and written once). At the
// drain's widths a row packs to about 500 bytes in ten short runs, so a
// block a row left most threads idle and ran the runs one after another;
// the (row, item) groups keep the runs' loads in flight side by side.
#include "maxima.cuh"

namespace {

enum { PACK_THREADS = 256, PACK_GROUP = 8, PACK_RUNS = 10, PACK_ITEMS = 1 + PACK_RUNS };

__device__ __forceinline__ long long source_row(const Args& a, long long i) {
    const long long row = arg_ptr<const int32_t>(a, K6_INDEX)[i];
    const long long rows = a.v[K6_ROWS];
    return row < 0 ? 0 : (row >= rows ? rows - 1 : row);
}

// one run of a packed row: `width` elements of `elem` bytes from the start
// of the source row of leaf `leaf` (rows `row_elems` elements apart), into
// the uint8 block when `u8`, else the int32 block
struct Run {
    int leaf, elem;
    long long width, row_elems;
    bool u8;
};

__device__ __forceinline__ Run run_of(const Args& a, int r) {
    const long long S = a.v[K6_S], M = a.v[K6_M], K = a.v[K6_K], KC = a.v[K6_KC];
    const long long mem_b = a.v[K6_MEM_B], sp_b = a.v[K6_SP_B];
    const long long st_b = a.v[K6_ST_B], conds_w = a.v[K6_CONDS_W];
    switch (r) {
        case 0: return {L_STACK, 4, sp_b * 16, S * 16, false};
        case 1: return {L_STORAGE_KEYS, 4, st_b * 16, K * 16, false};
        case 2: return {L_STORAGE_VALS, 4, st_b * 16, K * 16, false};
        case 3: return {L_STACK_SYM, 4, sp_b, S, false};
        case 4: return {L_MEM_SYM, 4, mem_b, M, false};
        case 5: return {L_STORAGE_SYM, 4, st_b, K, false};
        case 6: return {L_CONDS, 4, conds_w, KC, false};
        case 7: return {L_MEMORY, 1, mem_b, M, true};
        case 8: return {L_STORAGE_USED, 1, st_b, K, true};
        default: return {L_STORAGE_DIRTY, 1, st_b, K, true};
    }
}

// the source leaf of scalar word k of a packed row
__device__ __forceinline__ int scalar_leaf(int k) {
    switch (k) {
        case 0: return L_PC;
        case 1: return L_SP;
        case 2: return L_MSIZE;
        case 3: return L_CODE_LEN;
        case 4: return L_COND_COUNT;
        case 5: return L_CTX_ID;
        case 6: return L_LAST_JUMP;
        default: return L_BRANCHES;
    }
}

}  // namespace

__global__ void row_maxima_kernel(Args a) {
    const long long n = a.v[K6_N], slots = a.v[K6_K];
    const long long i = maxima::group_row(slots);
    const bool in = i < n;
    const long long r = in ? source_row(a, i) : 0;
    const int count = maxima::used_slots(
        in ? arg_ptr<const uint8_t>(a, K6_LEAF + L_STORAGE_USED) + r * slots : nullptr, slots);
    long long m[maxima::N] = {maxima::NONE, maxima::NONE, maxima::NONE, maxima::NONE};
    if (in) {
        m[0] = arg_ptr<const int32_t>(a, K6_LEAF + L_MSIZE)[r];
        m[1] = arg_ptr<const int32_t>(a, K6_LEAF + L_SP)[r];
        m[2] = count;
        m[3] = arg_ptr<const int32_t>(a, K6_LEAF + L_COND_COUNT)[r];
    }
    maxima::block_partials(m, arg_ptr<long long>(a, K6_PARTIAL));
}

// the second launch, one block: the four maxima into K6_OUT_MAXIMA
__global__ void row_maxima_combine_kernel(Args a) {
    maxima::combine(arg_ptr<const long long>(a, K6_PARTIAL),
                    maxima::blocks(a.v[K6_N], a.v[K6_K]), arg_ptr<long long>(a, K6_OUT_MAXIMA));
}

__global__ void pack_rows_kernel(Args a) {
    const long long n = a.v[K6_N];
    const long long g = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x)
                        / PACK_GROUP;
    const long long i = g / PACK_ITEMS;
    const int item = static_cast<int>(g % PACK_ITEMS), t = threadIdx.x % PACK_GROUP;
    if (i >= n) return;
    const long long src = source_row(a, i);
    int32_t* o32 = arg_ptr<int32_t>(a, K6_OUT_I32);
    if (item == 0) {
        if (t < 8) o32[t * n + i] = arg_ptr<const int32_t>(a, K6_LEAF + scalar_leaf(t))[src];
        if (t == 0)
            arg_ptr<long long>(a, K6_OUT_GAS)[i] =
                arg_ptr<const long long>(a, K6_LEAF + L_GAS_USED)[src];
        return;
    }
    // the run's block starts after the scalar words (int32) and the runs
    // before it of the same block, `n` rows each
    const Run run = run_of(a, item - 1);
    long long base = run.u8 ? 0 : 8 * n;
    for (int r = 0; r < item - 1; ++r) {
        const Run before = run_of(a, r);
        if (before.u8 == run.u8) base += n * before.width;
    }
    uint8_t* out = run.u8 ? arg_ptr<uint8_t>(a, K6_OUT_U8)
                          : reinterpret_cast<uint8_t*>(o32);
    const uint8_t* leaf = arg_ptr<const uint8_t>(a, K6_LEAF + run.leaf);
    copy_span(out + (base + i * run.width) * run.elem, leaf + src * run.row_elems * run.elem,
              run.width * run.elem, t, PACK_GROUP);
}

__global__ void reset_esc_kernel(Args a) {
    int32_t* count = arg_ptr<int32_t>(a, K6_ESC_COUNT);
    for (long long d = threadIdx.x; d < a.v[K6_ESC_SEGMENTS]; d += blockDim.x) count[d] = 0;
}

namespace {

// blocks and threads of the last launch of each entry (mtpu_pack_rows_grid):
// row_maxima's grid, pack_rows, reset_esc
int g_grid[6];

}  // namespace

MTPU_EXPORT int mtpu_row_maxima(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K6_N] <= 0 || a.v[K6_ROWS] <= 0 || !a.v[K6_PARTIAL])
        return 1;  // cudaErrorInvalidValue
    const long long blocks = maxima::blocks(a.v[K6_N], a.v[K6_K]);
    if (blocks > 0x7fffffffLL) return 1;
    g_grid[0] = static_cast<int>(blocks);
    g_grid[1] = maxima::THREADS;
    MTPU_LAUNCH(row_maxima_kernel, g_grid[0], g_grid[1], stream, a);
    const int rc = MTPU_LAUNCH_STATUS();
    if (rc) return rc;
    MTPU_LAUNCH(row_maxima_combine_kernel, 1, maxima::N * maxima::WARP, stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_pack_rows(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K6_N] <= 0 || a.v[K6_ROWS] <= 0) return 1;  // cudaErrorInvalidValue
    const long long per_block = PACK_THREADS / PACK_GROUP;
    const long long blocks = (a.v[K6_N] * PACK_ITEMS + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return 1;
    g_grid[2] = static_cast<int>(blocks);
    g_grid[3] = PACK_THREADS;
    MTPU_LAUNCH(pack_rows_kernel, g_grid[2], g_grid[3], stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_reset_esc(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    g_grid[4] = 1;
    g_grid[5] = block_threads(a.v[K6_ESC_SEGMENTS]);
    MTPU_LAUNCH(reset_esc_kernel, g_grid[4], g_grid[5], stream, a);
    return MTPU_LAUNCH_STATUS();
}

// out[0..5] = the grid and block size of the last launch of row_maxima
// (its combining launch is one block of 128), pack_rows and reset_esc
MTPU_EXPORT int mtpu_pack_rows_grid(long long* out, int n, void*) {
    for (int i = 0; i < n && i < 6; ++i) out[i] = g_grid[i];
    return 0;
}
