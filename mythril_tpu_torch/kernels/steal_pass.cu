// Kernel K12: the work-stealing pass of a sharded frontier.
//
// Replaces mythril_tpu/parallel/frontier.py:319 `_steal_pass` with its
// steal-row codec `_pack_steal_rows` / `_unpack_steal_rows` (252/267).
// The lane axis is D contiguous blocks and the DFS stack pool D segments of
// P/D rows, each with its top (stack_top int32[D]). Two launches from one
// host call, nothing read back by the host:
//
//   steal_plan  one block, a thread a lane (up to 1024). Each shard's
//               load is its block's RUNNING lanes plus its segment's
//               pending rows; the block counts the RUNNING lanes together
//               (a warp's 32 neighbouring lanes are one ballot, added to
//               their shard's count in shared memory; integer sums, so the
//               order does not matter). Shards are
//               ordered by a stable ascending sort of the load (equal loads
//               keep the lower shard first, as JAX's stable argsort does:
//               every thread counts the shards before its own), order[i]
//               pairs with order[D-1-i] for i < D/2, and a pair whose gap
//               reaches `min_imbalance` moves n = min(gap / 2, max_rows,
//               top[rich], P/D - top[poor]) rows: the donor's rows from its
//               top downward land at the receiver's top upward. The pairs
//               are disjoint, so every n reads the tops before the pass.
//               The plan writes one record a pair (the donor's top row,
//               the receiver's first free row, n) and updates the tops,
//               steals_sent, steals_received and steal_rows in place.
//   steal_move  one block per (pair, row, item) of K4's row copy plan
//               (ops._copy_plan: entries of at most 4 KB of one leaf,
//               grouped into items of at most 4 KB; common.cuh's
//               `copy_item`, 16-byte accesses where both ends and the
//               length allow), as K7's gather: about 10 blocks a row at the
//               frontier's default geometry. A block past its pair's n
//               exits at once. The JAX pass round trips the rows through
//               the steal-row codec, which is the identity on every field
//               it carries (its own codec test), so the kernel moves the
//               bytes; the plain twin keeps the codec and the CPU tests
//               hold the two to JAX. Rows above the donor's new top keep
//               their bytes, as in JAX.
//
// Bound: bytes, the moved rows read and written once (about 39 KB a row at
// the frontier's default geometry) plus the lane status and the tops.
#include "common.cuh"

namespace {

enum { MOVE_THREADS = 256, WARP = 32 };

// a pair's record in the move list: the donor's top row, the receiver's
// first free row, the rows moved
enum { MOVE_SRC = 0, MOVE_DST = 1, MOVE_N = 2, MOVE_FIELDS = 3 };

}  // namespace

__global__ void steal_plan_kernel(Args a) {
    __shared__ int load[1024], top[1024], order[1024], moved[512];
    const int t = threadIdx.x, nt = blockDim.x;
    const int B = arg_int(a, K12_B), D = arg_int(a, K12_D);
    const int seg_pool = arg_int(a, K12_P) / D, block = B / D;
    const int min_imbalance = arg_int(a, K12_MIN_IMBALANCE);
    const int max_rows = arg_int(a, K12_MAX_ROWS);
    const int32_t* status = arg_ptr<const int32_t>(a, K12_STATUS);
    int32_t* stack_top = arg_ptr<int32_t>(a, K12_STACK_TOP);

    for (int d = t; d < D; d += nt) load[d] = 0;
    __syncthreads();
    // RUNNING lanes per shard: a ballot a warp, one shared add when its 32
    // lanes lie in one shard, else one a RUNNING lane
    for (int base = 0; base < B; base += nt) {
        const int lane = base + t;
        const bool running = lane < B && status[lane] == ST_RUNNING;
        const unsigned votes = __ballot_sync(0xffffffffu, running);
        const int first = base + (t & ~(WARP - 1));
        const int last = first + WARP - 1 < B ? first + WARP - 1 : B - 1;
        if (first / block == last / block) {
            if (t % WARP == 0 && votes) atomicAdd(&load[first / block], __popc(votes));
        } else if (running) {
            atomicAdd(&load[lane / block], 1);
        }
    }
    __syncthreads();
    for (int d = t; d < D; d += nt) {
        top[d] = stack_top[d];
        load[d] += top[d];
    }
    __syncthreads();
    for (int d = t; d < D; d += nt) {
        int position = 0;
        for (int e = 0; e < D; ++e)
            position += load[e] < load[d] || (load[e] == load[d] && e < d);
        order[position] = d;
    }
    __syncthreads();
    int32_t* moves = arg_ptr<int32_t>(a, K12_MOVES);
    for (int i = t; i < D / 2; i += nt) {
        const int poor = order[i], rich = order[D - 1 - i];
        const int diff = load[rich] - load[poor];
        int n = diff / 2;
        n = n < max_rows ? n : max_rows;
        n = n < top[rich] ? n : top[rich];
        n = n < seg_pool - top[poor] ? n : seg_pool - top[poor];
        n = diff >= min_imbalance && n > 0 ? n : 0;
        moves[MOVE_FIELDS * i + MOVE_SRC] = rich * seg_pool + top[rich] - 1;
        moves[MOVE_FIELDS * i + MOVE_DST] = poor * seg_pool + top[poor];
        moves[MOVE_FIELDS * i + MOVE_N] = n;
        moved[i] = n;
        stack_top[rich] = top[rich] - n;
        stack_top[poor] = top[poor] + n;
        arg_ptr<long long>(a, K12_STEALS_SENT)[rich] += n;
        arg_ptr<long long>(a, K12_STEALS_RECEIVED)[poor] += n;
    }
    __syncthreads();
    if (t == 0) {
        long long total = 0;
        for (int i = 0; i < D / 2; ++i) total += moved[i];
        *arg_ptr<long long>(a, K12_STEAL_ROWS) += total;
    }
}

__global__ void steal_move_kernel(Args a) {
    const long long n_items = a.v[K12_N_ITEMS], max_rows = a.v[K12_MAX_ROWS];
    const long long pair = blockIdx.x / (max_rows * n_items);
    const long long r = blockIdx.x / n_items % max_rows;
    const int32_t* move = arg_ptr<const int32_t>(a, K12_MOVES) + MOVE_FIELDS * pair;
    if (r >= move[MOVE_N]) return;
    const long long src = move[MOVE_SRC] - r, dst = move[MOVE_DST] + r;
    auto row = [&](int f, long long at) {
        return arg_ptr<uint8_t>(a, K12_POOL + f) + at * a.v[K12_ROW_BYTES + f];
    };
    copy_item(arg_ptr<const int>(a, K12_ENTRIES), arg_ptr<const int>(a, K12_ITEMS),
              static_cast<int>(blockIdx.x % n_items), [&](int f) { return row(f, dst); },
              [&](int f) { return static_cast<const uint8_t*>(row(f, src)); });
}

namespace {

// the last pass's launches: plan blocks and threads, move blocks and
// threads (mtpu_steal_grid)
int g_steal_grid[4];

}  // namespace

MTPU_EXPORT int mtpu_steal_pass(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long B = a.v[K12_B], D = a.v[K12_D];
    const long long blocks = D / 2 * a.v[K12_MAX_ROWS] * a.v[K12_N_ITEMS];
    if (D < 2 || D > 1024 || B < D || B % D || a.v[K12_P] % D || a.v[K12_MAX_ROWS] < 1
        || a.v[K12_N_ITEMS] < 1 || blocks > 0x7fffffffLL)
        return 1;  // cudaErrorInvalidValue
    g_steal_grid[0] = 1;
    g_steal_grid[1] = block_threads(B > D ? B : D);
    g_steal_grid[2] = static_cast<int>(blocks);
    g_steal_grid[3] = MOVE_THREADS;
    MTPU_LAUNCH(steal_plan_kernel, g_steal_grid[0], g_steal_grid[1], stream, a);
    const int rc = MTPU_LAUNCH_STATUS();
    if (rc) return rc;
    MTPU_LAUNCH(steal_move_kernel, g_steal_grid[2], g_steal_grid[3], stream, a);
    return MTPU_LAUNCH_STATUS();
}

// out[0..3] = the plan's and the move's grid and block size, as the last
// pass launched them
MTPU_EXPORT int mtpu_steal_grid(long long* out, int n, void*) {
    for (int i = 0; i < n && i < 4; ++i) out[i] = g_steal_grid[i];
    return 0;
}
