// Kernel K8: the arena mirror's delta fetch.
//
// Replaces mythril_tpu/parallel/arena.py:185 `_fetch_delta`: rows
// [start, start+bucket) of the six node columns (op, a, b, c, imm, imm2)
// into int32[6, bucket], and const rows [cstart, cstart+cbucket) into
// int32[cbucket, 16]. The wrapper clamps both starts so the blocks fit, as
// `lax.dynamic_slice` does (and as the host mirror already asks).
//
// Bound: bytes (each element read once and written once); one grid-stride
// loop over both blocks, consecutive threads on consecutive words.
#include "common.cuh"

__global__ void arena_delta_kernel(Args a) {
    const long long bucket = a.v[K8_BUCKET], cbucket = a.v[K8_CBUCKET];
    const long long start = a.v[K8_START], cstart = a.v[K8_CSTART];
    const long long node_words = 6 * bucket, total = node_words + cbucket * 16;
    int32_t* rows = arg_ptr<int32_t>(a, K8_OUT_ROWS);
    int32_t* consts = arg_ptr<int32_t>(a, K8_OUT_CONSTS);
    const int32_t* const_vals = arg_ptr<const int32_t>(a, K8_CONST_VALS);
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         e < total; e += stride) {
        if (e < node_words) {
            const int col = static_cast<int>(e / bucket);
            rows[e] = arg_ptr<const int32_t>(a, K8_COL + col)[start + e % bucket];
        } else {
            const long long j = e - node_words;
            consts[j] = const_vals[cstart * 16 + j];
        }
    }
}

MTPU_EXPORT int mtpu_arena_delta(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K8_BUCKET] <= 0 || a.v[K8_CBUCKET] <= 0) return 1;  // cudaErrorInvalidValue
    const long long total = 6 * a.v[K8_BUCKET] + 16 * a.v[K8_CBUCKET];
    long long blocks = (total + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    MTPU_LAUNCH(arena_delta_kernel, static_cast<int>(blocks), 256, stream, a);
    return MTPU_LAUNCH_STATUS();
}
