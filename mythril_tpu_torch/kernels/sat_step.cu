// Kernel K11: one lockstep DPLL transition for every probe lane.
//
// Replaces mythril_tpu/parallel/jax_solver.py:247 `_step` under its
// runners `_get_runner` (384; freeze off) and `_get_batch_runner` (509;
// freeze on: a query stops once one probe is SAT or none is searching).
// One host call (`mtpu_sat_run`) launches a whole chunk of steps, as the
// JAX fori_loop runs inside one jitted runner; each step is
//
//   gate       (freeze only) decided[q] from the pre-step status of all of
//              q's probes, before either of the next launches writes one;
//   propagate  one thread per clause, looping over the query's searching
//              probes: three assignment gathers, a conflict flag (an
//              order-free OR) and, for a unit clause, the implication as
//              atomicMax(key[q, p, var], (clause + 1) << 1 | phase) — the
//              highest clause index wins, which is the last write of JAX's
//              tile-ordered scatter;
//   resolve    one block per (query, probe): one pass over V1 (newly
//              implied vars, the last flippable trail position, the
//              decision level, the argmin of `order` over free vars, first
//              index on ties), block scans and reductions, then exactly the
//              one branch the probe takes (conflict > units > SAT > decide),
//              appending implied vars in variable order by the scan's
//              ranks; it leaves the keys and the flag zero.
//
// Bound: bytes. A step reads each clause's literals once (12 B) and makes
// three one-byte assignment gathers per clause and searching probe, then
// scans V1 once per probe (assign, key, order, tag: 10 B a var). The
// gathers and scans hit L2 (a probe's assignment row is V1 bytes); the
// kernel is simple first: no shared-memory staging of the rows yet.
#include "common.cuh"

enum { SAT_UNASSIGNED = 0, SAT_TRUE = 1, SAT_FALSE = 2 };
enum { SAT_SEARCHING = 0, SAT_S_SAT = 1, SAT_S_UNSAT = 2 };
enum { SAT_PROP_THREADS = 256, SAT_GATE_THREADS = 128, SAT_MAX_PROBES = 1024 };
#define SAT_NOT_FREE (1LL << 30)
#define SAT_NO_PICK 0x7FFFFFFFFFFFFFFFLL

struct SatView {
    int8_t* assign;
    int32_t* trail;
    int8_t* tag;
    int32_t* trail_len;
    int8_t* status;
    const int32_t* lits;
    const bool* valid;
    const int32_t* order;
    int32_t* key;
    int32_t* conflict;
    int32_t* decided;
    long long Q, P, V1, C;
    int forced_depth;
};

__device__ __forceinline__ SatView sat_view(const Args& a) {
    SatView s;
    s.assign = arg_ptr<int8_t>(a, K11_ASSIGN);
    s.trail = arg_ptr<int32_t>(a, K11_TRAIL);
    s.tag = arg_ptr<int8_t>(a, K11_TAG);
    s.trail_len = arg_ptr<int32_t>(a, K11_TRAIL_LEN);
    s.status = arg_ptr<int8_t>(a, K11_STATUS);
    s.lits = arg_ptr<const int32_t>(a, K11_LITS);
    s.valid = arg_ptr<const bool>(a, K11_VALID);
    s.order = arg_ptr<const int32_t>(a, K11_ORDER);
    s.key = arg_ptr<int32_t>(a, K11_KEY);
    s.conflict = arg_ptr<int32_t>(a, K11_CONFLICT);
    s.decided = arg_ptr<int32_t>(a, K11_DECIDED);
    s.Q = a.v[K11_Q];
    s.P = a.v[K11_P];
    s.V1 = a.v[K11_V1];
    s.C = a.v[K11_C];
    s.forced_depth = arg_int(a, K11_FORCED_DEPTH);
    return s;
}

__device__ __forceinline__ int sat_abs(int x) { return x < 0 ? -x : x; }

__global__ void sat_gate_kernel(Args a) {
    const SatView s = sat_view(a);
    const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (q >= s.Q) return;
    int any_sat = 0, all_done = 1;
    for (long long p = 0; p < s.P; ++p) {
        const int8_t st = s.status[q * s.P + p];
        any_sat |= st == SAT_S_SAT;
        all_done &= st != SAT_SEARCHING;
    }
    s.decided[q] = any_sat | all_done;
}

__global__ void sat_propagate_kernel(Args a) {
    const SatView s = sat_view(a);
    __shared__ int active[SAT_MAX_PROBES];
    __shared__ int any_active;
    const long long per_query = (s.C + SAT_PROP_THREADS - 1) / SAT_PROP_THREADS;
    const long long q = blockIdx.x / per_query;
    const long long c = (blockIdx.x % per_query) * SAT_PROP_THREADS + threadIdx.x;
    const bool frozen = s.decided != nullptr && s.decided[q] != 0;
    if (threadIdx.x == 0) any_active = 0;
    __syncthreads();
    for (long long p = threadIdx.x; p < s.P; p += blockDim.x) {
        active[p] = !frozen && s.status[q * s.P + p] == SAT_SEARCHING;
        if (active[p]) any_active = 1;
    }
    __syncthreads();
    if (!any_active || c >= s.C || !s.valid[q * s.C + c]) return;
    const int32_t* clause = s.lits + (q * s.C + c) * 3;
    const int lit[3] = {clause[0], clause[1], clause[2]};
    const int key_base = static_cast<int>((c + 1) << 1);
    for (long long p = 0; p < s.P; ++p) {
        if (!active[p]) continue;
        const long long row = q * s.P + p;
        const int8_t* assign = s.assign + row * s.V1;
        bool sat = false;
        int n_unassigned = 0, unit = 0;
        for (int k = 0; k < 3; ++k) {
            if (lit[k] == 0) continue;
            const int8_t value = assign[sat_abs(lit[k])];
            if (value == SAT_UNASSIGNED) {
                if (n_unassigned++ == 0) unit = lit[k];
            } else if ((value == SAT_TRUE) == (lit[k] > 0)) {
                sat = true;
                break;
            }
        }
        if (sat) continue;
        if (n_unassigned == 0) {
            s.conflict[row] = 1;
        } else if (n_unassigned == 1) {
            atomicMax(s.key + row * s.V1 + sat_abs(unit), key_base | (unit > 0 ? 1 : 0));
        }
    }
}

__global__ void sat_resolve_kernel(Args a) {
    const SatView s = sat_view(a);
    __shared__ int scan_buf[1024];
    __shared__ long long max_buf[1024];
    const long long row = blockIdx.x;  // q * P + p
    const long long q = row / s.P, p = row % s.P;
    if ((s.decided != nullptr && s.decided[q] != 0) || s.status[row] != SAT_SEARCHING)
        return;  // uniform over the block: no barrier is skipped by part of it
    const long long V1 = s.V1;
    int8_t* assign = s.assign + row * V1;
    int32_t* trail = s.trail + row * V1;
    int8_t* tag = s.tag + row * V1;
    int32_t* key = s.key + row * V1;
    const int32_t* order = s.order + q * V1;
    const int conflict = s.conflict[row];
    const long long len = s.trail_len[row];

    // one pass over this thread's run of vars (and trail positions)
    const long long per = (V1 + blockDim.x - 1) / blockDim.x;
    const long long lo = threadIdx.x * per < V1 ? threadIdx.x * per : V1;
    const long long hi = lo + per < V1 ? lo + per : V1;
    int n_new = 0, level = 0;
    long long flip = -1, pick = SAT_NO_PICK, any_free = 0;
    for (long long v = lo; v < hi; ++v) {
        const bool unassigned = v != 0 && assign[v] == SAT_UNASSIGNED;
        if (unassigned) {
            if (key[v] != 0) ++n_new;
            any_free = 1;
        }
        const long long rank = unassigned ? order[v] : SAT_NOT_FREE;
        const long long candidate = (rank << 32) | v;
        if (candidate < pick) pick = candidate;
        if (v < len) {
            const int8_t t = tag[v];
            level += t >= 1;
            if (t == 1) flip = v;
        }
    }
    int total_new = 0, total_level = 0;
    const int offset = block_exclusive_scan(n_new, scan_buf, &total_new);
    block_exclusive_scan(level, scan_buf, &total_level);
    const long long flip_pos_max = block_max(flip, max_buf);
    const long long best = -block_max(-pick, max_buf);
    const bool free_any = block_max(any_free, max_buf) != 0;

    if (conflict) {
        // backtrack to the last flippable decision (none: position 0, and
        // the probe's cube is refuted)
        const bool has_flip = flip_pos_max >= 0;
        const long long flip_pos = has_flip ? flip_pos_max : 0;
        for (long long i = flip_pos + 1 + threadIdx.x; i < len; i += blockDim.x)
            assign[sat_abs(trail[i])] = SAT_UNASSIGNED;
        if (total_new)
            for (long long v = lo; v < hi; ++v)
                if (key[v] != 0) key[v] = 0;
        __syncthreads();
        if (threadIdx.x == 0) {
            const int flip_lit = trail[flip_pos];
            if (has_flip) assign[sat_abs(flip_lit)] = flip_lit > 0 ? SAT_FALSE : SAT_TRUE;
            trail[flip_pos] = -flip_lit;
            tag[flip_pos] = 2;
            s.trail_len[row] = static_cast<int32_t>(has_flip ? flip_pos + 1 : len);
            s.status[row] = has_flip ? SAT_SEARCHING : SAT_S_UNSAT;
            s.conflict[row] = 0;
        }
    } else if (total_new) {
        // assert every implied literal, appended in variable order
        long long r = len + offset;
        for (long long v = lo; v < hi; ++v) {
            const int k = key[v];
            if (k == 0) continue;
            key[v] = 0;
            if (v == 0 || assign[v] != SAT_UNASSIGNED) continue;
            const bool phase_true = (k & 1) != 0;
            assign[v] = phase_true ? SAT_TRUE : SAT_FALSE;
            if (r < V1) {
                trail[r] = static_cast<int32_t>(phase_true ? v : -v);
                tag[r] = 0;
            }
            ++r;
        }
        if (threadIdx.x == 0) s.trail_len[row] = static_cast<int32_t>(len + total_new);
    } else if (!free_any) {
        if (threadIdx.x == 0) s.status[row] = SAT_S_SAT;
    } else if (threadIdx.x == 0) {
        // decide: the forced cube prefix first, then FALSE
        const int d_var = static_cast<int>(best & 0xFFFFFFFFLL);
        const bool in_prefix = total_level < s.forced_depth;
        const int shift = total_level < 0 ? 0 : (total_level > 30 ? 30 : total_level);
        const bool phase_true = in_prefix && ((p >> shift) & 1);
        assign[d_var] = phase_true ? SAT_TRUE : SAT_FALSE;
        const long long d_pos = len < 0 ? 0 : (len > V1 - 1 ? V1 - 1 : len);
        trail[d_pos] = phase_true ? d_var : -d_var;
        tag[d_pos] = in_prefix ? 2 : 1;
        s.trail_len[row] = static_cast<int32_t>(len + 1);
    }
}

MTPU_EXPORT int mtpu_sat_run(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const long long Q = a.v[K11_Q], P = a.v[K11_P], V1 = a.v[K11_V1], C = a.v[K11_C];
    if (Q <= 0 || P <= 0 || P > SAT_MAX_PROBES || V1 < 2 || V1 > (1LL << 31) || C <= 0
        || C >= (1LL << 30))
        return 1;  // cudaErrorInvalidValue
    const long long prop_blocks = Q * ((C + SAT_PROP_THREADS - 1) / SAT_PROP_THREADS);
    if (prop_blocks > 0x7FFFFFFFLL || Q * P > 0x7FFFFFFFLL) return 1;
    const int res_threads = block_threads((V1 + 31) / 32);
    const int gate_blocks = static_cast<int>((Q + SAT_GATE_THREADS - 1) / SAT_GATE_THREADS);
    const bool freeze = a.v[K11_DECIDED] != 0;
    for (long long step = 0; step < a.v[K11_STEPS]; ++step) {
        if (freeze) MTPU_LAUNCH(sat_gate_kernel, gate_blocks, SAT_GATE_THREADS, stream, a);
        MTPU_LAUNCH(sat_propagate_kernel, static_cast<int>(prop_blocks), SAT_PROP_THREADS,
                    stream, a);
        MTPU_LAUNCH(sat_resolve_kernel, static_cast<int>(Q * P), res_threads, stream, a);
        const int rc = MTPU_LAUNCH_STATUS();
        if (rc) return rc;
    }
    return 0;
}
