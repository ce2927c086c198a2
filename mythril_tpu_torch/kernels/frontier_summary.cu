// Kernel K5: the frontier's per-chunk summary, one block.
//
// Replaces mythril_tpu/parallel/frontier.py:99 `_summary`. Writes ONE int64
// vector of 13 + 3B words, the only read the driver blocks on each chunk:
//   [stack_top, esc_count, executed, forks, pushes, pops, arena_n,
//    arena_n_const, esc_msize_max, esc_sp_max, esc_slots_max,
//    esc_conds_max, B] + status[B] + fork_cond[B] + ctx_id[B]
// The four maxima run over the live escape rows (row < esc_count), with a
// non-live row counting as 0, as the JAX program's `where(live, x, 0)`
// does; esc_slots is a row's count of used storage slots. Only the
// single-shard scheduler without telemetry is ported (the wrapper's caller
// refuses the others).
//
// Bound: bytes (the live rows' four columns, one storage_used row each,
// and the three lane columns); one block strides over the rows and reduces
// in shared memory, which is plenty for the main path's 1024 rows.
#include "common.cuh"

__global__ void frontier_summary_kernel(Args a) {
    __shared__ long long buf[1024];
    const int t = threadIdx.x, nt = blockDim.x;
    const int rows = arg_int(a, K5_E), slots = arg_int(a, K5_K);
    const int batch = arg_int(a, K5_B);
    const long long live = *arg_ptr<const int32_t>(a, K5_ESC_COUNT);
    const int32_t* msize = arg_ptr<const int32_t>(a, K5_ESC_MSIZE);
    const int32_t* sp = arg_ptr<const int32_t>(a, K5_ESC_SP);
    const uint8_t* used = arg_ptr<const uint8_t>(a, K5_ESC_STORAGE_USED);
    const int32_t* conds = arg_ptr<const int32_t>(a, K5_ESC_COND_COUNT);

    // a non-live row contributes 0; with every row live, nothing does
    const long long init = live < rows ? 0 : (-0x7fffffffffffffffLL - 1);
    long long m_msize = init, m_sp = init, m_slots = init, m_conds = init;
    for (int r = t; r < rows && r < live; r += nt) {
        int count = 0;
        for (int k = 0; k < slots; ++k) count += used[(long long)r * slots + k] != 0;
        if (msize[r] > m_msize) m_msize = msize[r];
        if (sp[r] > m_sp) m_sp = sp[r];
        if (count > m_slots) m_slots = count;
        if (conds[r] > m_conds) m_conds = conds[r];
    }
    m_msize = block_max(m_msize, buf);
    m_sp = block_max(m_sp, buf);
    m_slots = block_max(m_slots, buf);
    m_conds = block_max(m_conds, buf);

    long long* out = arg_ptr<long long>(a, K5_OUT);
    if (t == 0) {
        out[0] = *arg_ptr<const int32_t>(a, K5_STACK_TOP);
        out[1] = live;
        out[2] = *arg_ptr<const long long>(a, K5_EXECUTED);
        out[3] = *arg_ptr<const long long>(a, K5_FORKS);
        out[4] = *arg_ptr<const long long>(a, K5_PUSHES);
        out[5] = *arg_ptr<const long long>(a, K5_POPS);
        out[6] = *arg_ptr<const int32_t>(a, K5_ARENA_N);
        out[7] = *arg_ptr<const int32_t>(a, K5_ARENA_N_CONST);
        out[8] = m_msize;
        out[9] = m_sp;
        out[10] = m_slots;
        out[11] = m_conds;
        out[12] = batch;
    }
    const int32_t* status = arg_ptr<const int32_t>(a, K5_STATUS);
    const int32_t* fork_cond = arg_ptr<const int32_t>(a, K5_FORK_COND);
    const int32_t* ctx_id = arg_ptr<const int32_t>(a, K5_CTX_ID);
    for (int i = t; i < batch; i += nt) {
        out[13 + i] = status[i];
        out[13 + batch + i] = fork_cond[i];
        out[13 + 2LL * batch + i] = ctx_id[i];
    }
}

MTPU_EXPORT int mtpu_frontier_summary(const long long* values, int n,
                                      void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K5_E] <= 0 || a.v[K5_B] <= 0) return 1;  // cudaErrorInvalidValue
    const long long most = a.v[K5_E] > a.v[K5_B] ? a.v[K5_E] : a.v[K5_B];
    MTPU_LAUNCH(frontier_summary_kernel, 1, block_threads(most), stream, a);
    return MTPU_LAUNCH_STATUS();
}
