// Kernel K12: the work-stealing pass of a sharded frontier.
//
// Replaces mythril_tpu/parallel/frontier.py:319 `_steal_pass` with its
// steal-row codec `_pack_steal_rows` / `_unpack_steal_rows` (252/267).
// The lane axis is D contiguous blocks and the DFS stack pool D segments of
// P/D rows, each with its top (stack_top int32[D]). Two launches, nothing
// read back by the host:
//
//   steal_plan  one block. Each shard's load is its block's RUNNING lanes
//               plus its segment's pending rows. Shards are ordered by a
//               stable ascending sort of the load (equal loads keep the
//               lower shard first, as JAX's stable argsort does: every
//               thread counts the shards before its own), order[i] pairs
//               with order[D-1-i] for i < D/2, and a pair whose gap reaches
//               `min_imbalance` moves n = min(gap / 2, max_rows, top[rich],
//               P/D - top[poor]) rows: the donor's rows from its top
//               downward land at the receiver's top upward. The pairs are
//               disjoint, so every n reads the tops before the pass. The
//               plan writes the move list (source and destination row of
//               each of max_rows slots a pair, -1 where none moves) and
//               updates the tops, steals_sent, steals_received and
//               steal_rows in place.
//   steal_move  one block per move-list slot: a listed row's 46 leaves
//               from the donor's row to the receiver's with common.cuh's
//               `copy_bytes` (16-byte accesses where both ends allow, as
//               K4's and K7's rows). The JAX pass round
//               trips the rows through the steal-row codec, which is the
//               identity on every field it carries (its own codec test),
//               so the kernel moves the bytes; the plain twin keeps the
//               codec and the CPU tests hold the two to JAX. Rows above
//               the donor's new top keep their bytes, as in JAX.
//
// Bound: bytes, the moved rows read and written once (about 39 KB a row at
// the frontier's default geometry) plus the lane status and the tops. A
// slot with no move exits at once; the moves of one pass are at most
// D/2 * max_rows blocks, each copying a whole row.
#include "common.cuh"

__global__ void steal_plan_kernel(Args a) {
    __shared__ int load[1024], top[1024], order[1024], moved[512];
    const int t = threadIdx.x, nt = blockDim.x;
    const int B = arg_int(a, K12_B), D = arg_int(a, K12_D);
    const int seg_pool = arg_int(a, K12_P) / D, block = B / D;
    const int min_imbalance = arg_int(a, K12_MIN_IMBALANCE);
    const int max_rows = arg_int(a, K12_MAX_ROWS);
    const int32_t* status = arg_ptr<const int32_t>(a, K12_STATUS);
    int32_t* stack_top = arg_ptr<int32_t>(a, K12_STACK_TOP);

    for (int d = t; d < D; d += nt) {
        int running = 0;
        for (int lane = d * block; lane < (d + 1) * block; ++lane)
            running += status[lane] == ST_RUNNING;
        top[d] = stack_top[d];
        load[d] = running + top[d];
    }
    __syncthreads();
    for (int d = t; d < D; d += nt) {
        int position = 0;
        for (int e = 0; e < D; ++e)
            position += load[e] < load[d] || (load[e] == load[d] && e < d);
        order[position] = d;
    }
    __syncthreads();
    int32_t* move_src = arg_ptr<int32_t>(a, K12_MOVE_SRC);
    int32_t* move_dst = arg_ptr<int32_t>(a, K12_MOVE_DST);
    for (int i = t; i < D / 2; i += nt) {
        const int poor = order[i], rich = order[D - 1 - i];
        const int diff = load[rich] - load[poor];
        int n = diff / 2;
        n = n < max_rows ? n : max_rows;
        n = n < top[rich] ? n : top[rich];
        n = n < seg_pool - top[poor] ? n : seg_pool - top[poor];
        n = diff >= min_imbalance && n > 0 ? n : 0;
        for (int r = 0; r < max_rows; ++r) {
            const long long slot = static_cast<long long>(i) * max_rows + r;
            move_src[slot] = rich * seg_pool + top[rich] - 1 - r;
            move_dst[slot] = r < n ? poor * seg_pool + top[poor] + r : -1;
        }
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
    const long long slot = blockIdx.x;
    const long long dst = arg_ptr<const int32_t>(a, K12_MOVE_DST)[slot];
    if (dst < 0) return;
    const long long src = arg_ptr<const int32_t>(a, K12_MOVE_SRC)[slot];
    for (int f = 0; f < N_ROW_LEAVES; ++f) {
        const long long bytes = a.v[K12_ROW_BYTES + f];
        uint8_t* leaf = arg_ptr<uint8_t>(a, K12_POOL + f);
        copy_bytes(leaf + dst * bytes, leaf + src * bytes, bytes);
    }
}

MTPU_EXPORT int mtpu_steal_plan(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long B = a.v[K12_B], D = a.v[K12_D];
    if (D < 2 || D > 1024 || B % D || a.v[K12_P] % D || a.v[K12_MAX_ROWS] < 1)
        return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(steal_plan_kernel, 1, block_threads(D), stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_steal_move(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long slots = a.v[K12_D] / 2 * a.v[K12_MAX_ROWS];
    if (slots <= 0 || slots > 0x7fffffffLL) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(steal_move_kernel, static_cast<int>(slots), 128, stream, a);
    return MTPU_LAUNCH_STATUS();
}
