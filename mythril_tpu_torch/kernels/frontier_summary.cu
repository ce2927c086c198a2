// Kernel K5: the frontier's per-chunk summary, one block.
//
// Replaces mythril_tpu/parallel/frontier.py:99 `_summary`. Writes ONE int64
// vector of 13 + 3B words, the only read the driver blocks on each chunk:
//   [stack_top, esc_count, executed, forks, pushes, pops, arena_n,
//    arena_n_const, esc_msize_max, esc_sp_max, esc_slots_max,
//    esc_conds_max, B] + status[B] + fork_cond[B] + ctx_id[B]
// and, when the telemetry plane is armed, its words at the end
// (frontier.py:138-140): op_hist | lifecycle | esc_cause | occupancy | hwm |
// tag_occ | fleet_occ, as symstep.telemetry_words lays them out.
// The four maxima run over the live escape rows (row < esc_count), with a
// non-live row counting as 0, as the JAX program's `where(live, x, 0)`
// does; esc_slots is a row's count of used storage slots.
// A sharded scheduler (K5_D = D > 1) has int32[D] tops: slots 0/1 hold
// their sums, a row of escape segment d is live below esc_count[d]
// (frontier.py:114-118), and the shard block [stack_top[D], esc_count[D],
// steals_sent[D], steals_received[D], steal_rows] comes last, after the
// telemetry words (146-153).
//
// Bound: bytes (the live rows' four columns, one storage_used row each,
// and the three lane columns); one block strides over the rows and reduces
// in shared memory, which is plenty for the main path's 1024 rows.
#include "common.cuh"

__global__ void frontier_summary_kernel(Args a) {
    __shared__ long long buf[1024];
    const int t = threadIdx.x, nt = blockDim.x;
    const int rows = arg_int(a, K5_E), slots = arg_int(a, K5_K);
    const int batch = arg_int(a, K5_B), n_seg = arg_int(a, K5_D);
    const int seg_rows = rows / n_seg;
    const int32_t* esc_count = arg_ptr<const int32_t>(a, K5_ESC_COUNT);
    const int32_t* stack_top = arg_ptr<const int32_t>(a, K5_STACK_TOP);
    long long live = 0, top = 0;
    for (int d = 0; d < n_seg; ++d) {
        live += esc_count[d];
        top += stack_top[d];
    }
    const int32_t* msize = arg_ptr<const int32_t>(a, K5_ESC_MSIZE);
    const int32_t* sp = arg_ptr<const int32_t>(a, K5_ESC_SP);
    const uint8_t* used = arg_ptr<const uint8_t>(a, K5_ESC_STORAGE_USED);
    const int32_t* conds = arg_ptr<const int32_t>(a, K5_ESC_COND_COUNT);

    // a non-live row contributes 0; with every row live, nothing does
    const long long init = live < rows ? 0 : (-0x7fffffffffffffffLL - 1);
    long long m_msize = init, m_sp = init, m_slots = init, m_conds = init;
    for (int r = t; r < rows; r += nt) {
        if (r % seg_rows >= esc_count[r / seg_rows]) continue;
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
        out[0] = top;
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
    long long at = 13 + 3LL * batch;
    if (a.v[K5_TEL_OP_HIST]) {
        const int n_tags = arg_int(a, K5_TEL_N_TAGS), n_fleet = arg_int(a, K5_TEL_N_FLEET);
        const int parts[7] = {K5_TEL_OP_HIST, K5_TEL_LIFECYCLE, K5_TEL_ESC_CAUSE,
                              K5_TEL_OCCUPANCY, K5_TEL_HWM, K5_TEL_TAG_OCC,
                              K5_TEL_FLEET_OCC};
        const int sizes[7] = {N_OP_CLASSES, N_LIFECYCLE, N_ESC_CAUSES, 2, 2, n_tags, n_fleet};
        for (int p = 0; p < 7; ++p) {
            const long long* src = arg_ptr<const long long>(a, parts[p]);
            for (int i = t; i < sizes[p]; i += nt) out[at + i] = src[i];
            at += sizes[p];
        }
    }
    if (n_seg < 2) return;
    const long long* sent = arg_ptr<const long long>(a, K5_STEALS_SENT);
    const long long* recv = arg_ptr<const long long>(a, K5_STEALS_RECEIVED);
    for (int d = t; d < n_seg; d += nt) {
        out[at + d] = stack_top[d];
        out[at + n_seg + d] = esc_count[d];
        out[at + 2 * n_seg + d] = sent[d];
        out[at + 3 * n_seg + d] = recv[d];
    }
    if (t == 0) out[at + 4 * n_seg] = *arg_ptr<const long long>(a, K5_STEAL_ROWS);
}

MTPU_EXPORT int mtpu_frontier_summary(const long long* values, int n,
                                      void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K5_E] <= 0 || a.v[K5_B] <= 0 || a.v[K5_D] <= 0 || a.v[K5_E] % a.v[K5_D])
        return 1;  // cudaErrorInvalidValue
    const long long most = a.v[K5_E] > a.v[K5_B] ? a.v[K5_E] : a.v[K5_B];
    MTPU_LAUNCH(frontier_summary_kernel, 1, block_threads(most), stream, a);
    return MTPU_LAUNCH_STATUS();
}
