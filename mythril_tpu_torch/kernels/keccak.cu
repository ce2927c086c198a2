// Kernel K1: batched keccak-256, one message per thread.
//
// Replaces mythril_tpu/parallel/keccak.py:137 `keccak256` (over `keccak_f`,
// keccak.py:126), which the JAX step reaches for SHA3 (lockstep.py:292-298).
// Message i is row i of `data` (stride bytes apart) read from `offset[i]`
// (0 when absent) for `len[i]` bytes, with bytes at or past `limit[i]`
// (msize for SHA3; the row width when absent) reading 0. Lanes whose
// `mask` byte is 0 get a zero digest. Bound: operations, 24 keccak rounds
// of 64-bit xor/rotate per block per message; one thread per message keeps
// the 200-byte state in registers.
#include "keccak.cuh"

__global__ void keccak_rows_kernel(Args a) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= arg_int(a, K1_BATCH)) return;
    uint8_t* out = arg_ptr<uint8_t>(a, K1_OUT) + 32LL * lane;
    const uint8_t* mask = arg_ptr<const uint8_t>(a, K1_MASK);
    if (mask && !mask[lane]) {
        for (int k = 0; k < 32; ++k) out[k] = 0;
        return;
    }
    const long long ncols = a.v[K1_NCOLS];
    const long long* offset = arg_ptr<const long long>(a, K1_OFFSET);
    const int* limit = arg_ptr<const int>(a, K1_LIMIT);
    long long lim = limit ? limit[lane] : ncols;
    if (lim > ncols) lim = ncols;
    const uint8_t* row = arg_ptr<const uint8_t>(a, K1_DATA) + a.v[K1_STRIDE] * lane;
    keccak256_dev(row, offset ? offset[lane] : 0, lim,
                  arg_ptr<const int>(a, K1_LEN)[lane], out);
}

MTPU_EXPORT int mtpu_keccak_rows(const long long* values, int n,
                                 void* stream) {
    Args a = mtpu_pack(values, n);
    const int batch = static_cast<int>(a.v[K1_BATCH]);
    if (batch <= 0) return 0;
    const int threads = 128;
    MTPU_LAUNCH(keccak_rows_kernel, (batch + threads - 1) / threads, threads,
                stream, a);
    return MTPU_LAUNCH_STATUS();
}

// load this source's kernel (before a CUDA graph captures it)
MTPU_EXPORT int mtpu_keccak_preload(const long long*, int, void*) {
    return MTPU_PRELOAD(keccak_rows_kernel);
}
