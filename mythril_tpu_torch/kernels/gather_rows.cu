// Kernel K7: full-row gather and scatter over every leaf of a lane row
// (the 46 leaves of StateBatch + SymPlanes, 39,306 bytes a row at the
// frontier's default geometry).
//
//   mtpu_gather_rows   replaces frontier.py:79 `_gather_rows`:
//                      row i of the flat block = lane row index[i] of every
//                      leaf (an out-of-range index clamps, as JAX's gather
//                      does);
//   mtpu_scatter_rows  replaces frontier.py:88 `_scatter_rows`:
//                      lane row index[i] = row i of the flat block, dropping
//                      an index outside [0, rows) (the `mode="drop"`
//                      padding). Indices are distinct by construction
//                      (reseeds pick distinct DEAD lanes), so no two blocks
//                      write one byte.
//
// The flat block holds n rows leaf-major: leaf f's n rows are one slab at
// K7_BASE + slab[f] (ops.gather_rows allocates it as one buffer, each slab
// 16-byte aligned; a scatter from separate tensors passes base 0 and their
// pointers as slabs).
//
// Grid: one block per (row, item) of the row copy plan that K4's row moves
// use (ops._copy_plan: entries of at most 4 KB of one leaf, grouped into
// items of at most 4 KB), so about 10 blocks a row, each copying up to
// 4 KB with common.cuh's `copy_item` (16-byte accesses where both ends and
// the length allow). Bound: bytes (each row read once and written once).
#include "common.cuh"

namespace {

enum { ROW_THREADS = 256 };

struct RowItem {
    long long i;  // row of the flat block
    int item;     // item of the copy plan
};

__device__ __forceinline__ RowItem row_item(const Args& a) {
    const int n_items = arg_int(a, K7_N_ITEMS);
    return {static_cast<long long>(blockIdx.x / n_items), static_cast<int>(blockIdx.x % n_items)};
}

__device__ __forceinline__ uint8_t* lane_row(const Args& a, int f, long long row) {
    return arg_ptr<uint8_t>(a, K7_LANE + f) + row * a.v[K7_ROW_BYTES + f];
}

__device__ __forceinline__ uint8_t* flat_row(const Args& a, int f, long long i) {
    return reinterpret_cast<uint8_t*>(static_cast<uintptr_t>(a.v[K7_BASE] + a.v[K7_SLAB + f]))
           + i * a.v[K7_ROW_BYTES + f];
}

}  // namespace

__global__ void gather_rows_kernel(Args a) {
    const RowItem r = row_item(a);
    const long long rows = a.v[K7_ROWS];
    long long row = arg_ptr<const int32_t>(a, K7_INDEX)[r.i];
    row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);
    copy_item(arg_ptr<const int>(a, K7_ENTRIES), arg_ptr<const int>(a, K7_ITEMS), r.item,
              [&](int f) { return flat_row(a, f, r.i); },
              [&](int f) { return static_cast<const uint8_t*>(lane_row(a, f, row)); });
}

__global__ void scatter_rows_kernel(Args a) {
    const RowItem r = row_item(a);
    const long long row = arg_ptr<const int32_t>(a, K7_INDEX)[r.i];
    if (row < 0 || row >= a.v[K7_ROWS]) return;  // dropped
    copy_item(arg_ptr<const int>(a, K7_ENTRIES), arg_ptr<const int>(a, K7_ITEMS), r.item,
              [&](int f) { return lane_row(a, f, row); },
              [&](int f) { return static_cast<const uint8_t*>(flat_row(a, f, r.i)); });
}

// blocks of the (row, item) grid, or 0 if the call is invalid
static long long row_blocks(const Args& a) {
    const long long blocks = a.v[K7_N] * a.v[K7_N_ITEMS];
    if (a.v[K7_N] <= 0 || a.v[K7_N_ITEMS] <= 0 || blocks > 0x7fffffffLL || a.v[K7_ROWS] <= 0)
        return 0;
    return blocks;
}

MTPU_EXPORT int mtpu_gather_rows(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long blocks = row_blocks(a);
    if (!blocks) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(gather_rows_kernel, static_cast<int>(blocks), ROW_THREADS, stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_scatter_rows(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long blocks = row_blocks(a);
    if (!blocks) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(scatter_rows_kernel, static_cast<int>(blocks), ROW_THREADS, stream, a);
    return MTPU_LAUNCH_STATUS();
}
