// Kernel K8: the arena mirror's delta fetch, landed in host memory.
//
// Replaces mythril_tpu/parallel/arena.py:185 `_fetch_delta` and the host
// copy of `HostArena.refresh_async` around it: rows [start, start+bucket)
// of the six node columns (op, a, b, c, imm, imm2) as int32[6, bucket],
// then const rows [cstart, cstart+cbucket) as int32[cbucket, 16], written
// into one slot of the mirror's pinned staging. The wrapper clamps both
// starts so the blocks fit, as `lax.dynamic_slice` does (and as the host
// mirror already asks).
//
// Bound: bytes, and of them the write across PCIe into host memory (the
// delta read once from device memory takes a few percent of that). A
// refresh was a kernel into two fresh device outputs, two pinned host
// allocations and two copy-engine transfers; now it is this one launch,
// which stores straight into the staging through its mapped device
// address: no device output, no transfer, no allocation. The grid is
// (block, slice of it): blocks 0-5 are the columns, block 6 the consts,
// each cut into 4 KB slices, one pass of a CUDA block, so that the writes
// leave from many SMs (16 KB slices took the same time on the card);
// consecutive threads take consecutive 16-byte words where the start and
// bucket allow (copy_span), so they reach the host as full lines.
#include "common.cuh"

namespace {

enum { SLICE_BYTES = 4096 };

}  // namespace

__global__ void arena_delta_kernel(Args a) {
    const long long bucket = a.v[K8_BUCKET], cbucket = a.v[K8_CBUCKET];
    const int slices = gridDim.x / 7, block = blockIdx.x / slices;
    const long long bytes = block < 6 ? 4 * bucket : 64 * cbucket;
    const long long off = static_cast<long long>(blockIdx.x % slices) * SLICE_BYTES;
    if (off >= bytes) return;
    uint8_t* dst = block < 6
        ? arg_ptr<uint8_t>(a, K8_OUT_ROWS) + block * 4 * bucket
        : arg_ptr<uint8_t>(a, K8_OUT_CONSTS);
    const uint8_t* src = block < 6
        ? arg_ptr<const uint8_t>(a, K8_COL + block) + 4 * a.v[K8_START]
        : arg_ptr<const uint8_t>(a, K8_CONST_VALS) + 64 * a.v[K8_CSTART];
    copy_span(dst + off, src + off, bytes - off < SLICE_BYTES ? bytes - off : SLICE_BYTES,
              threadIdx.x, blockDim.x);
}

MTPU_EXPORT int mtpu_arena_delta(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K8_BUCKET] <= 0 || a.v[K8_CBUCKET] <= 0) return 1;  // cudaErrorInvalidValue
    const long long most = 4 * a.v[K8_BUCKET] > 64 * a.v[K8_CBUCKET] ? 4 * a.v[K8_BUCKET]
                                                                     : 64 * a.v[K8_CBUCKET];
    const long long slices = (most + SLICE_BYTES - 1) / SLICE_BYTES;
    MTPU_LAUNCH(arena_delta_kernel, static_cast<int>(7 * slices), 256, stream, a);
    return MTPU_LAUNCH_STATUS();
}

// The device address of pinned host memory: values[0] the host address,
// the device address written to values[1] (cudaHostGetDevicePointer).
MTPU_EXPORT int mtpu_arena_delta_map(long long* values, int n, void*) {
    if (n < 2) return 1;  // cudaErrorInvalidValue
    void* device = nullptr;
    const int rc = static_cast<int>(cudaHostGetDevicePointer(
        &device, reinterpret_cast<void*>(static_cast<uintptr_t>(values[0])), 0));
    values[1] = static_cast<long long>(reinterpret_cast<uintptr_t>(device));
    return rc;
}
