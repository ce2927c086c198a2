// Kernel K6: the drain's row programs. Three entries:
//
//   mtpu_row_maxima  replaces frontier.py:191 `_row_maxima`: int64[4] =
//                    max msize, sp, used storage slots and cond_count over
//                    the selected rows (one block, shared-memory reduce);
//   mtpu_pack_rows   replaces frontier.py:156 `_pack_rows`: one block per
//                    selected row, its threads over the row's fields, into
//                    three flat blocks at exactly the offsets the host's
//                    drain_unpack reads:
//                      int32: pc, sp, msize, code_len, cond_count, ctx_id,
//                             last_jump, branches (one word a row each),
//                             stack[:sp_b], storage_keys[:st_b],
//                             storage_vals[:st_b] (16 limbs a slot, the
//                             uint32 limbs as their bit patterns),
//                             stack_sym[:sp_b], mem_sym[:mem_b],
//                             storage_sym[:st_b], conds[:conds_w]
//                      uint8: memory[:mem_b], storage_used[:st_b],
//                             storage_dirty[:st_b]
//                      int64: gas_used
//   mtpu_reset_esc   replaces frontier.py:248 `_reset_esc`: one thread
//                    zeroes the escape count, each segment's of a sharded
//                    scheduler (K6_ESC_SEGMENTS of them).
//
// The index may repeat index[0] (power-of-two padding) or hold zeros
// (padding of an escape drain): gathers only read, so duplicates are
// harmless; out-of-range entries clamp, as JAX's gather does.
//
// Bound: bytes (each packed byte read once and written once). Every field
// kept is a prefix of its row, so each block copies a few contiguous runs.
#include "common.cuh"

namespace {

__device__ __forceinline__ long long source_row(const Args& a, long long i) {
    const long long row = arg_ptr<const int32_t>(a, K6_INDEX)[i];
    const long long rows = a.v[K6_ROWS];
    return row < 0 ? 0 : (row >= rows ? rows - 1 : row);
}

template <class T>
__device__ __forceinline__ void copy_run(T* dst, const T* src, long long count) {
    for (long long j = threadIdx.x; j < count; j += blockDim.x) dst[j] = src[j];
}

}  // namespace

__global__ void row_maxima_kernel(Args a) {
    __shared__ long long buf[1024];
    const long long n = a.v[K6_N];
    const int slots = arg_int(a, K6_K);
    const int32_t* msize = arg_ptr<const int32_t>(a, K6_LEAF + L_MSIZE);
    const int32_t* sp = arg_ptr<const int32_t>(a, K6_LEAF + L_SP);
    const uint8_t* used = arg_ptr<const uint8_t>(a, K6_LEAF + L_STORAGE_USED);
    const int32_t* conds = arg_ptr<const int32_t>(a, K6_LEAF + L_COND_COUNT);
    const long long lowest = -0x7fffffffffffffffLL - 1;
    long long m_msize = lowest, m_sp = lowest, m_slots = lowest, m_conds = lowest;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
        const long long r = source_row(a, i);
        int count = 0;
        for (int k = 0; k < slots; ++k) count += used[r * slots + k] != 0;
        if (msize[r] > m_msize) m_msize = msize[r];
        if (sp[r] > m_sp) m_sp = sp[r];
        if (count > m_slots) m_slots = count;
        if (conds[r] > m_conds) m_conds = conds[r];
    }
    m_msize = block_max(m_msize, buf);
    m_sp = block_max(m_sp, buf);
    m_slots = block_max(m_slots, buf);
    m_conds = block_max(m_conds, buf);
    if (threadIdx.x == 0) {
        long long* out = arg_ptr<long long>(a, K6_OUT_MAXIMA);
        out[0] = m_msize;
        out[1] = m_sp;
        out[2] = m_slots;
        out[3] = m_conds;
    }
}

__global__ void pack_rows_kernel(Args a) {
    const long long i = blockIdx.x, n = a.v[K6_N];
    const long long src = source_row(a, i);
    const long long S = a.v[K6_S], M = a.v[K6_M], K = a.v[K6_K], KC = a.v[K6_KC];
    const long long mem_b = a.v[K6_MEM_B], sp_b = a.v[K6_SP_B];
    const long long st_b = a.v[K6_ST_B], conds_w = a.v[K6_CONDS_W];
    int32_t* o32 = arg_ptr<int32_t>(a, K6_OUT_I32);
    uint8_t* o8 = arg_ptr<uint8_t>(a, K6_OUT_U8);

    const int scalar_leaf[8] = {L_PC, L_SP, L_MSIZE, L_CODE_LEN, L_COND_COUNT,
                                L_CTX_ID, L_LAST_JUMP, L_BRANCHES};
    if (threadIdx.x < 8)
        o32[threadIdx.x * n + i] =
            arg_ptr<const int32_t>(a, K6_LEAF + scalar_leaf[threadIdx.x])[src];
    if (threadIdx.x == 0)
        arg_ptr<long long>(a, K6_OUT_GAS)[i] =
            arg_ptr<const long long>(a, K6_LEAF + L_GAS_USED)[src];

    long long base = 8 * n;
    copy_run(o32 + base + i * sp_b * 16,
             arg_ptr<const int32_t>(a, K6_LEAF + L_STACK) + src * S * 16, sp_b * 16);
    base += n * sp_b * 16;
    copy_run(o32 + base + i * st_b * 16,
             arg_ptr<const int32_t>(a, K6_LEAF + L_STORAGE_KEYS) + src * K * 16,
             st_b * 16);
    base += n * st_b * 16;
    copy_run(o32 + base + i * st_b * 16,
             arg_ptr<const int32_t>(a, K6_LEAF + L_STORAGE_VALS) + src * K * 16,
             st_b * 16);
    base += n * st_b * 16;
    copy_run(o32 + base + i * sp_b,
             arg_ptr<const int32_t>(a, K6_LEAF + L_STACK_SYM) + src * S, sp_b);
    base += n * sp_b;
    copy_run(o32 + base + i * mem_b,
             arg_ptr<const int32_t>(a, K6_LEAF + L_MEM_SYM) + src * M, mem_b);
    base += n * mem_b;
    copy_run(o32 + base + i * st_b,
             arg_ptr<const int32_t>(a, K6_LEAF + L_STORAGE_SYM) + src * K, st_b);
    base += n * st_b;
    copy_run(o32 + base + i * conds_w,
             arg_ptr<const int32_t>(a, K6_LEAF + L_CONDS) + src * KC, conds_w);

    copy_run(o8 + i * mem_b,
             arg_ptr<const uint8_t>(a, K6_LEAF + L_MEMORY) + src * M, mem_b);
    copy_run(o8 + n * mem_b + i * st_b,
             arg_ptr<const uint8_t>(a, K6_LEAF + L_STORAGE_USED) + src * K, st_b);
    copy_run(o8 + n * (mem_b + st_b) + i * st_b,
             arg_ptr<const uint8_t>(a, K6_LEAF + L_STORAGE_DIRTY) + src * K, st_b);
}

__global__ void reset_esc_kernel(Args a) {
    int32_t* count = arg_ptr<int32_t>(a, K6_ESC_COUNT);
    for (long long d = 0; d < a.v[K6_ESC_SEGMENTS]; ++d) count[d] = 0;
}

MTPU_EXPORT int mtpu_row_maxima(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K6_N] <= 0 || a.v[K6_ROWS] <= 0) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(row_maxima_kernel, 1, block_threads(a.v[K6_N]), stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_pack_rows(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K6_N] <= 0 || a.v[K6_ROWS] <= 0) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(pack_rows_kernel, static_cast<int>(a.v[K6_N]), 128, stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_reset_esc(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    MTPU_LAUNCH(reset_esc_kernel, 1, 1, stream, a);
    return MTPU_LAUNCH_STATUS();
}
