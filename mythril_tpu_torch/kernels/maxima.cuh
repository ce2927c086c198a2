// The four row maxima of kernels K5 (frontier_summary.cu, over the escape
// rows) and K6 (pack_rows.cu `row_maxima`, over the drain's selected rows):
// msize, sp, used storage slots and cond_count, as int64.
//
// A launch of THREADS threads a block takes a group of group_lanes(K) lanes
// a row (ceil(K / 16) rounded up to a power of two, at most a warp), so a
// warp takes 32 / lanes neighbouring rows (64 rows a block at K = 64); each
// lane counts the nonzero bytes of 16-byte loads of the row's storage_used
// (a byte path when the row or K is not 16-byte aligned). The warp reduces
// the four maxima with shuffles, the block over its warps, and four threads
// write the block's to four words of an int64 scratch; a second launch of
// one block (a warp a maximum) combines every block's. Maxima are
// order-free, so the blocks may run in any order.
#pragma once

#include "common.cuh"

namespace maxima {

enum { THREADS = 256, WARP = 32, N = 4 };
constexpr long long NONE = -0x7fffffffffffffffLL - 1;

__device__ __forceinline__ long long max64(long long x, long long y) { return x > y ? x : y; }

// nonzero bytes of a 32-bit word
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
    return __popc((((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u);
}

// the lanes of a row's group: ceil(K / 16) rounded up to a power of two, at
// most a warp
__host__ __device__ __forceinline__ int group_lanes(long long slots) {
    int lanes = 1;
    while (lanes < WARP && 16LL * lanes < slots) lanes <<= 1;
    return lanes;
}

// the blocks of a launch over `rows` rows of `slots` storage slots
__host__ __device__ __forceinline__ long long blocks(long long rows, long long slots) {
    const long long rows_per_block = THREADS / WARP * (WARP / group_lanes(slots));
    return (rows + rows_per_block - 1) / rows_per_block;
}

// the row position of the calling thread's group
__device__ __forceinline__ long long group_row(long long slots) {
    const int lanes = group_lanes(slots);
    return (static_cast<long long>(blockIdx.x) * (blockDim.x / WARP) + threadIdx.x / WARP)
           * (WARP / lanes) + threadIdx.x % WARP / lanes;
}

// The used slots of a row (`used`: its `slots` storage_used bytes, or null
// for none), counted by its group. Every lane of the warp calls it.
__device__ __forceinline__ int used_slots(const uint8_t* used, long long slots) {
    const int lanes = group_lanes(slots), k = threadIdx.x % WARP % lanes;
    int count = 0;
    if (used) {
        if (((reinterpret_cast<uintptr_t>(used) | static_cast<uintptr_t>(slots)) & 15) == 0) {
            for (long long off = 16LL * k; off < slots; off += 16LL * lanes) {
                const Vec16 v = *reinterpret_cast<const Vec16*>(used + off);
                count += nonzero_bytes(v.x) + nonzero_bytes(v.y) + nonzero_bytes(v.z)
                         + nonzero_bytes(v.w);
            }
        } else {
            for (long long off = k; off < slots; off += lanes) count += used[off] != 0;
        }
    }
    for (int offset = lanes / 2; offset > 0; offset >>= 1)
        count += __shfl_xor_sync(0xffffffffu, count, offset);
    return count;
}

// The block's maxima of every thread's m[] (NONE for a thread without a
// row) into partial[N * blockIdx.x + q]. Every thread of the block calls
// it; every block has a row.
__device__ __forceinline__ void block_partials(long long (&m)[N], long long* partial) {
    __shared__ long long buf[THREADS / WARP * N];
    const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
    for (int q = 0; q < N; ++q)
        for (int offset = WARP / 2; offset > 0; offset >>= 1)
            m[q] = max64(m[q], __shfl_xor_sync(0xffffffffu, m[q], offset));
    if (lane == 0)
        for (int q = 0; q < N; ++q) buf[warp * N + q] = m[q];
    __syncthreads();
    if (threadIdx.x < N) {
        long long best = NONE;
        for (int w = 0; w < static_cast<int>(blockDim.x) / WARP; ++w)
            best = max64(best, buf[w * N + threadIdx.x]);
        partial[blockIdx.x * N + threadIdx.x] = best;
    }
}

// The combining launch, one block of N warps: warp q takes maximum q over
// the first `blocks` blocks' partials, into out[q].
__device__ __forceinline__ void combine(const long long* partial, long long blocks,
                                        long long* out) {
    const int lane = threadIdx.x % WARP, q = threadIdx.x / WARP;
    if (q >= N) return;
    long long best = NONE;
    for (long long b = lane; b < blocks; b += WARP) best = max64(best, partial[b * N + q]);
    for (int offset = WARP / 2; offset > 0; offset >>= 1)
        best = max64(best, __shfl_xor_sync(0xffffffffu, best, offset));
    if (lane == 0) out[q] = best;
}

}  // namespace maxima
