// Kernel K7: full-row gather and scatter over every leaf of a lane row
// (the 46 leaves of StateBatch + SymPlanes, about 39 KB a row at the
// default geometry).
//
//   mtpu_gather_rows   replaces frontier.py:79 `_gather_rows`:
//                      dst[i] = src[index[i]] for every leaf (out-of-range
//                      indices clamp, as JAX's gather does);
//   mtpu_scatter_rows  replaces frontier.py:88 `_scatter_rows`:
//                      dst[index[i]] = src[i], dropping an index outside
//                      [0, rows) (the `mode="drop"` padding). Indices are
//                      distinct by construction (reseeds pick distinct
//                      DEAD lanes), so no two blocks write one row.
//
// Grid: one block per (row, leaf); the block copies the leaf's row with
// 16-byte accesses when both ends and the length allow, else 4-byte, else
// byte accesses. Bound: bytes (each row read once and written once).
#include "common.cuh"

namespace {

struct alignas(16) Vec16 {
    uint32_t x, y, z, w;
};

template <class T>
__device__ __forceinline__ void copy_as(uint8_t* dst, const uint8_t* src,
                                        long long bytes) {
    T* d = reinterpret_cast<T*>(dst);
    const T* s = reinterpret_cast<const T*>(src);
    const long long count = bytes / static_cast<long long>(sizeof(T));
    for (long long j = threadIdx.x; j < count; j += blockDim.x) d[j] = s[j];
}

__device__ __forceinline__ void copy_row(uint8_t* dst, const uint8_t* src,
                                         long long bytes) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(dst)
                           | reinterpret_cast<uintptr_t>(src)
                           | static_cast<uintptr_t>(bytes);
    if ((bits & 15) == 0) copy_as<Vec16>(dst, src, bytes);
    else if ((bits & 3) == 0) copy_as<uint32_t>(dst, src, bytes);
    else copy_as<uint8_t>(dst, src, bytes);
}

}  // namespace

__global__ void gather_rows_kernel(Args a) {
    const int leaf = blockIdx.x % N_ROW_LEAVES;
    const long long i = blockIdx.x / N_ROW_LEAVES;
    const long long bytes = a.v[K7_ROW_BYTES + leaf];
    const long long rows = a.v[K7_SRC_ROWS];
    long long row = arg_ptr<const int32_t>(a, K7_INDEX)[i];
    row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);
    copy_row(arg_ptr<uint8_t>(a, K7_DST + leaf) + i * bytes,
             arg_ptr<const uint8_t>(a, K7_SRC + leaf) + row * bytes, bytes);
}

__global__ void scatter_rows_kernel(Args a) {
    const int leaf = blockIdx.x % N_ROW_LEAVES;
    const long long i = blockIdx.x / N_ROW_LEAVES;
    const long long bytes = a.v[K7_ROW_BYTES + leaf];
    const long long row = arg_ptr<const int32_t>(a, K7_INDEX)[i];
    if (row < 0 || row >= a.v[K7_DST_ROWS]) return;  // dropped
    copy_row(arg_ptr<uint8_t>(a, K7_DST + leaf) + row * bytes,
             arg_ptr<const uint8_t>(a, K7_SRC + leaf) + i * bytes, bytes);
}

// blocks of a (row, leaf) grid, or 0 if the call is invalid
static long long row_blocks(const Args& a) {
    const long long blocks = a.v[K7_N] * N_ROW_LEAVES;
    if (a.v[K7_N] <= 0 || blocks > 0x7fffffffLL || a.v[K7_SRC_ROWS] <= 0)
        return 0;
    return blocks;
}

MTPU_EXPORT int mtpu_gather_rows(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long blocks = row_blocks(a);
    if (!blocks) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(gather_rows_kernel, static_cast<int>(blocks), 128, stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_scatter_rows(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long blocks = row_blocks(a);
    if (!blocks) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(scatter_rows_kernel, static_cast<int>(blocks), 128, stream, a);
    return MTPU_LAUNCH_STATUS();
}
