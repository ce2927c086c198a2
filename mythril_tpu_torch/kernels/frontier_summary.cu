// Kernel K5: the frontier's per-chunk summary.
//
// Replaces mythril_tpu/parallel/frontier.py:99 `_summary`. Writes ONE int64
// vector of 13 + 3B words, the only read the driver blocks on each chunk:
//   [stack_top, esc_count, executed, forks, pushes, pops, arena_n,
//    arena_n_const, esc_msize_max, esc_sp_max, esc_slots_max,
//    esc_conds_max, B] + status[B] + fork_cond[B] + ctx_id[B]
// and, when the telemetry plane is armed, its words at the end
// (frontier.py:138-140): op_hist | lifecycle | esc_cause | occupancy | hwm |
// tag_occ | fleet_occ, as symstep.telemetry_words lays them out.
// The four maxima run over every escape row, a live one (row < its
// segment's esc_count) giving its value and a non-live one 0, as the JAX
// program's `where(live, x, 0).max()` does; esc_slots is a row's count of
// used storage slots.
// A sharded scheduler (K5_D = D > 1) has int32[D] tops: slots 0/1 hold
// their sums, a row of escape segment d is live below esc_count[d]
// (frontier.py:114-118), and the shard block [stack_top[D], esc_count[D],
// steals_sent[D], steals_received[D], steal_rows] comes last, after the
// telemetry words (146-153).
//
// Bound: bytes (the escape rows' four columns, one storage_used row each,
// and the three lane columns), but at the main path's 1024 rows the work
// is a few microseconds of latency. The grid spreads it: the maxima are
// maxima.cuh's, shared with K6 (64 rows a block at K = 64 storage slots,
// four words a block of an int64 scratch, which a second launch of one
// block combines; a fold in the last block to arrive saved a launch but no
// clear time on the card, and needs an arrival counter: PERF.md). Block 0
// writes the header, which needs no row; the lane columns, the telemetry
// words and the shard block go to every thread of the grid.
#include "maxima.cuh"

namespace {

using maxima::WARP;
enum { SUMMARY_THREADS = maxima::THREADS };

// the lane columns, the telemetry words and the shard block: one word per
// thread of the grid
__device__ __forceinline__ void copy_words(const Args& a, long long* out, long long at) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long batch = a.v[K5_B];
    const int* columns[3] = {arg_ptr<const int32_t>(a, K5_STATUS),
                             arg_ptr<const int32_t>(a, K5_FORK_COND),
                             arg_ptr<const int32_t>(a, K5_CTX_ID)};
    for (long long i = first; i < 3 * batch; i += stride)
        out[13 + i] = columns[i / batch][i % batch];
    if (a.v[K5_TEL_OP_HIST]) {
        const int parts[7] = {K5_TEL_OP_HIST, K5_TEL_LIFECYCLE, K5_TEL_ESC_CAUSE,
                              K5_TEL_OCCUPANCY, K5_TEL_HWM, K5_TEL_TAG_OCC,
                              K5_TEL_FLEET_OCC};
        const int sizes[7] = {N_OP_CLASSES, N_LIFECYCLE, N_ESC_CAUSES, 2, 2,
                              arg_int(a, K5_TEL_N_TAGS), arg_int(a, K5_TEL_N_FLEET)};
        for (int p = 0; p < 7; ++p) {
            const long long* src = arg_ptr<const long long>(a, parts[p]);
            for (long long i = first; i < sizes[p]; i += stride) out[at + i] = src[i];
            at += sizes[p];
        }
    }
    const int n_seg = arg_int(a, K5_D);
    if (n_seg < 2) return;
    const int32_t* stack_top = arg_ptr<const int32_t>(a, K5_STACK_TOP);
    const int32_t* esc_count = arg_ptr<const int32_t>(a, K5_ESC_COUNT);
    const long long* sent = arg_ptr<const long long>(a, K5_STEALS_SENT);
    const long long* recv = arg_ptr<const long long>(a, K5_STEALS_RECEIVED);
    for (long long d = first; d < n_seg; d += stride) {
        out[at + d] = stack_top[d];
        out[at + n_seg + d] = esc_count[d];
        out[at + 2 * n_seg + d] = sent[d];
        out[at + 3 * n_seg + d] = recv[d];
    }
    if (first == 0) out[at + 4 * n_seg] = *arg_ptr<const long long>(a, K5_STEAL_ROWS);
}

// block 0: the header (the sums of the segments' tops and escape counts,
// the scheduler's and the arena's scalars, B), which no other block's
// rows change
__device__ __forceinline__ void header(const Args& a, long long* out, long long* sums) {
    const int t = threadIdx.x, n_seg = arg_int(a, K5_D);
    const int32_t* stack_top = arg_ptr<const int32_t>(a, K5_STACK_TOP);
    const int32_t* esc_count = arg_ptr<const int32_t>(a, K5_ESC_COUNT);
    long long top = 0, live = 0;
    for (int d = t; d < n_seg; d += blockDim.x) {
        top += stack_top[d];
        live += esc_count[d];
    }
    for (int offset = WARP / 2; offset > 0; offset >>= 1) {
        top += __shfl_xor_sync(0xffffffffu, top, offset);
        live += __shfl_xor_sync(0xffffffffu, live, offset);
    }
    const int warps = blockDim.x / WARP;
    if (t % WARP == 0) {
        sums[t / WARP] = top;
        sums[warps + t / WARP] = live;
    }
    __syncthreads();
    if (t == 0) {
        top = live = 0;
        for (int w = 0; w < warps; ++w) {
            top += sums[w];
            live += sums[warps + w];
        }
        out[0] = top;
        out[1] = live;
        out[2] = *arg_ptr<const long long>(a, K5_EXECUTED);
        out[3] = *arg_ptr<const long long>(a, K5_FORKS);
        out[4] = *arg_ptr<const long long>(a, K5_PUSHES);
        out[5] = *arg_ptr<const long long>(a, K5_POPS);
        out[6] = *arg_ptr<const int32_t>(a, K5_ARENA_N);
        out[7] = *arg_ptr<const int32_t>(a, K5_ARENA_N_CONST);
        out[12] = a.v[K5_B];
    }
}

}  // namespace

__global__ void frontier_summary_kernel(Args a) {
    __shared__ long long sums[2 * SUMMARY_THREADS / WARP];
    const long long rows = a.v[K5_E], slots = a.v[K5_K];
    const long long seg_rows = rows / a.v[K5_D];
    long long* out = arg_ptr<long long>(a, K5_OUT);
    copy_words(a, out, 13 + 3 * a.v[K5_B]);
    if (blockIdx.x == 0) header(a, out, sums);

    // a non-live row gives 0, one past the end none
    const long long row = maxima::group_row(slots);
    const bool in = row < rows;
    const bool live = in && row % seg_rows < arg_ptr<const int32_t>(a, K5_ESC_COUNT)[row / seg_rows];
    const int count = maxima::used_slots(
        in ? arg_ptr<const uint8_t>(a, K5_ESC_STORAGE_USED) + row * slots : nullptr, slots);
    long long m[maxima::N] = {maxima::NONE, maxima::NONE, maxima::NONE, maxima::NONE};
    if (in) {
        m[0] = live ? arg_ptr<const int32_t>(a, K5_ESC_MSIZE)[row] : 0;
        m[1] = live ? arg_ptr<const int32_t>(a, K5_ESC_SP)[row] : 0;
        m[2] = live ? count : 0;
        m[3] = live ? arg_ptr<const int32_t>(a, K5_ESC_COND_COUNT)[row] : 0;
    }
    maxima::block_partials(m, arg_ptr<long long>(a, K5_PARTIAL));
}

// the second launch, one block: the four maxima into out[8..11]
__global__ void frontier_summary_combine_kernel(Args a) {
    maxima::combine(arg_ptr<const long long>(a, K5_PARTIAL),
                    maxima::blocks(a.v[K5_E], a.v[K5_K]), arg_ptr<long long>(a, K5_OUT) + 8);
}

namespace {

// blocks and threads of the last summary launch (mtpu_frontier_summary_grid)
int g_summary_grid[2];

}  // namespace

MTPU_EXPORT int mtpu_frontier_summary(const long long* values, int n, void* stream) {
    const Args a = mtpu_pack(values, n);
    if (a.v[K5_E] <= 0 || a.v[K5_B] <= 0 || a.v[K5_D] <= 0 || a.v[K5_E] % a.v[K5_D]
        || a.v[K5_K] < 0 || !a.v[K5_PARTIAL])
        return 1;  // cudaErrorInvalidValue
    const long long blocks = maxima::blocks(a.v[K5_E], a.v[K5_K]);
    if (blocks > 0x7fffffffLL) return 1;
    g_summary_grid[0] = static_cast<int>(blocks);
    g_summary_grid[1] = SUMMARY_THREADS;
    MTPU_LAUNCH(frontier_summary_kernel, g_summary_grid[0], SUMMARY_THREADS, stream, a);
    const int rc = MTPU_LAUNCH_STATUS();
    if (rc) return rc;
    MTPU_LAUNCH(frontier_summary_combine_kernel, 1, maxima::N * WARP, stream, a);
    return MTPU_LAUNCH_STATUS();
}

// out[0], out[1] = the grid and block size of the last summary launch
// (its combining launch is one block of 128)
MTPU_EXPORT int mtpu_frontier_summary_grid(long long* out, int n, void*) {
    for (int i = 0; i < n && i < 2; ++i) out[i] = g_summary_grid[i];
    return 0;
}
