// Kernel K1: keccak-256 of memory ranges, in two forms that share
// keccak.cuh's staging, padding and permutation.
//
// Replaces mythril_tpu/parallel/keccak.py:137 `keccak256` (over `keccak_f`,
// keccak.py:126), which the JAX step reaches for SHA3 (lockstep.py:287-299).
//
// The step form (`keccak_step_kernel`) runs once per symbolic step, between
// K4's pre launches and `evm_step`, on K2's parameter block. It finds its
// own SHA3 lanes with K2's lane helpers (evm_lane.cuh): a lane hashes when
// it runs and is not forced out, its opcode is SHA3, and its length word
// fits in 32 bits and is at most 512 bytes (SHA3_MAX; a longer one escapes
// in K2). Its message is memory[offset, offset + length), the offset the
// low 32 bits of the top word, bytes at or past msize reading 0. A lane
// that does not hash exits at once and writes nothing: K2 reads the digest
// (K2_DIGEST) only on lanes that commit a SHA3, and those are exactly the
// hashing ones. This is the counterpart of the JAX step's
// `lax.cond(any(sha_mask & ~sha_escape))`, which a launch inside a CUDA
// graph cannot skip. A block of one warp takes one lane, so the lanes
// spread over the SMs: the warp stages the message (at most four rate
// blocks) into shared memory, thread 0 absorbs and permutes
// (keccak.cuh `hash_warp` with one message).
//
// The standalone form (`keccak_rows_kernel`, behind `keccak.keccak256`):
// message i is row i of `data` (stride bytes apart) read from `offset[i]`
// (0 when absent) for `len[i]` bytes, with bytes at or past `limit[i]`
// (the row width when absent) reading 0; lanes whose `mask` byte is 0 get
// a zero digest. A block of one warp takes K1_PER_WARP messages (a power
// of two up to 32), one a thread, so that that many permutations run side
// by side: four rate blocks at a time, the warp stages every message's
// window in turn, then each thread absorbs its own. The wrapper spreads a
// batch over the SMs first: a message a warp (as in the step form) while
// the warps are fewer than the SMs, then more messages a warp (PERF.md: a
// warp a message left 31 of 32 lanes idle at 4096 messages, 32 messages a
// warp left most SMs idle at 128).
//
// Bound: operations, 24 keccak rounds of 64-bit xor/rotate per block per
// message; the state stays in registers.
#include "evm_lane.cuh"
#include "keccak.cuh"

namespace {

using keccak::WARP;
enum { SHA3_MAX = 512 };  // lockstep.SHA3_MAX

}  // namespace

__global__ void keccak_step_kernel(Args a) {
    __shared__ Vec16 staged[keccak::WINDOW_BYTES / 16];
    const int lane = blockIdx.x;
    // whether the lane hashes, uniform over the block
    if (!running_of(a, lane)) return;
    const int sp = arg_ptr<int32_t>(a, L_SP)[lane];
    if (op_at(a, lane, arg_ptr<int32_t>(a, L_PC)[lane]) != OP_SHA3) return;
    bool off_fits, len_fits;
    const long long off = w_low32(w_load16(slot_ptr(a, lane, sp, 1)), &off_fits);
    const long long len = w_low32(w_load16(slot_ptr(a, lane, sp, 2)), &len_fits);
    if (!len_fits || len > SHA3_MAX) return;
    const long long M = arg_int(a, K2_M);
    const long long msize = arg_ptr<int32_t>(a, L_MSIZE)[lane];
    const keccak::Job job = {true, {arg_ptr<const uint8_t>(a, L_MEMORY) + lane * M, M, off,
                                    msize < M ? msize : M, len}};
    keccak::hash_warp(1, [&](int) { return job; }, reinterpret_cast<uint8_t*>(staged),
                      threadIdx.x == 0 ? arg_ptr<uint8_t>(a, K2_DIGEST) + 32LL * lane : nullptr);
}

__global__ void keccak_rows_kernel(Args a) {
    __shared__ Vec16 staged[WARP * keccak::WINDOW_BYTES / 16];
    const int per = arg_int(a, K1_PER_WARP);
    const long long batch = a.v[K1_BATCH], first = static_cast<long long>(blockIdx.x) * per;
    const long long ncols = a.v[K1_NCOLS];
    const long long* offset = arg_ptr<const long long>(a, K1_OFFSET);
    const int* limit = arg_ptr<const int>(a, K1_LIMIT);
    const uint8_t* mask = arg_ptr<const uint8_t>(a, K1_MASK);
    auto job = [&](int k) -> keccak::Job {
        const long long i = first + k;
        if (i >= batch || (mask && !mask[i])) return {};
        const long long lim = limit ? limit[i] : ncols;
        return {true, {arg_ptr<const uint8_t>(a, K1_DATA) + a.v[K1_STRIDE] * i, ncols,
                       offset ? offset[i] : 0, lim < ncols ? lim : ncols,
                       arg_ptr<const int>(a, K1_LEN)[i]}};
    };
    const long long i = first + threadIdx.x;
    keccak::hash_warp(per, job, reinterpret_cast<uint8_t*>(staged),
                      static_cast<int>(threadIdx.x) < per && i < batch
                          ? arg_ptr<uint8_t>(a, K1_OUT) + 32 * i : nullptr);
}

namespace {

// blocks and threads of the last step-form launch (mtpu_keccak_step_grid)
int g_step_grid[2];

}  // namespace

MTPU_EXPORT int mtpu_keccak_rows(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long batch = a.v[K1_BATCH];
    if (batch <= 0) return 0;
    const long long per = a.v[K1_PER_WARP];
    if (per < 1 || per > WARP || (batch + per - 1) / per > 0x7fffffffLL)
        return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(keccak_rows_kernel, static_cast<int>((batch + per - 1) / per), WARP, stream,
                a);
    return MTPU_LAUNCH_STATUS();
}

// the step form, on K2's parameter block: one block of a warp per lane
MTPU_EXPORT int mtpu_keccak_step(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long batch = a.v[K2_B];
    if (batch <= 0) return 0;
    if (!a.v[K2_DIGEST] || batch > 0x7fffffffLL) return 1;  // cudaErrorInvalidValue
    g_step_grid[0] = static_cast<int>(batch);
    g_step_grid[1] = WARP;
    MTPU_LAUNCH(keccak_step_kernel, g_step_grid[0], g_step_grid[1], stream, a);
    return MTPU_LAUNCH_STATUS();
}

// out[0], out[1] = the grid and block size of the last step-form launch
MTPU_EXPORT int mtpu_keccak_step_grid(long long* out, int n, void*) {
    for (int i = 0; i < n && i < 2; ++i) out[i] = g_step_grid[i];
    return 0;
}

// load this source's kernels (before a CUDA graph captures them)
MTPU_EXPORT int mtpu_keccak_preload(const long long*, int, void*) {
    return MTPU_PRELOAD(keccak_step_kernel) | MTPU_PRELOAD(keccak_rows_kernel);
}
