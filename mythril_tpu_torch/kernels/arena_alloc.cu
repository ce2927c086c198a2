// Kernel K3: arena node and constant allocation, one block.
//
// Replaces mythril_tpu/parallel/arena.py:105 `alloc_rows` and :146
// `alloc_consts`. Every wanting entry appends one node: its id is the bump
// pointer `n` plus the entry's rank among the wanting entries, taken from a
// block-wide exclusive scan and never from atomics, so ids and entry order
// equal the JAX package's. Entries past capacity get id 0 and an overflow
// flag; the pointer saturates at capacity (arena.py:136,168). A VAR node's
// `cls` is its class bit, a CONST node's 0, any other node's the union of
// its children's masks, read before this call writes anything. In const
// mode (`values` given) the words first go to the const pool the same way
// and the CONST nodes wrap them. The arena is updated in place.
//
// Each thread owns a contiguous run of entries (one entry per thread up to
// 1024 of them; the merge pass allocates over up to half * S entries): a
// serial count, one block scan, then a serial walk that hands out the
// ranks. The const ids and each node's child mask wait in `out_ids` /
// `out_ovf` between the two scans, so `out_ids` must not alias an input.
//
// Bound: bytes (a few int32 per entry, plus one 64-byte word per const).
// The allocation rules (class masks, node rows) are arena.cuh's, which
// sym_step.cu shares for the four allocations it folds into its step.
#include "arena.cuh"

__global__ void arena_alloc_kernel(Args a) {
    __shared__ int scan_buf[1024];
    const long long batch = a.v[K3_BATCH];
    const long long per = (batch + blockDim.x - 1) / blockDim.x;
    const long long first = static_cast<long long>(threadIdx.x) * per;
    const long long lo = first < batch ? first : batch;
    const long long hi = lo + per < batch ? lo + per : batch;
    const uint8_t* want = arg_ptr<const uint8_t>(a, K3_WANT);
    int32_t* out_ids = arg_ptr<int32_t>(a, K3_OUT_IDS);
    uint8_t* out_ovf = arg_ptr<uint8_t>(a, K3_OUT_OVF);

    int* n_ptr = arg_ptr<int>(a, K3_N);
    const int cap = arg_int(a, K3_CAP);
    const ArenaRef ar = {arg_ptr<int32_t>(a, K3_COL_OP), arg_ptr<int32_t>(a, K3_COL_A),
                         arg_ptr<int32_t>(a, K3_COL_B), arg_ptr<int32_t>(a, K3_COL_C),
                         arg_ptr<int32_t>(a, K3_COL_IMM), arg_ptr<int32_t>(a, K3_COL_IMM2),
                         arg_ptr<int32_t>(a, K3_COL_CLS), arg_ptr<int32_t>(a, K3_CONST_VALS),
                         cap, a.v[K3_CCAP]};
    const int32_t* values = arg_ptr<const int32_t>(a, K3_VALUES);
    int total;
    if (values) {
        // const pool: the word of the k-th wanting entry goes to n_const + k;
        // out_ids keeps its pool index, out_ovf whether the pool was full
        int* nc_ptr = arg_ptr<int>(a, K3_N_CONST);
        const int ccap = arg_int(a, K3_CCAP);
        const int nc0 = *nc_ptr;
        int count = 0;
        for (long long i = lo; i < hi; ++i) count += want[i] != 0;
        long long cid = static_cast<long long>(nc0)
                        + block_exclusive_scan(count, scan_buf, &total);
        for (long long i = lo; i < hi; ++i) {
            const bool covf = want[i] && cid >= ccap;
            if (want[i] && !covf) {
                int32_t* dst = ar.const_vals + cid * 16;
                for (int k = 0; k < 16; ++k) dst[k] = values[16 * i + k];
            }
            out_ids[i] = want[i] ? static_cast<int>(cid) : 0;
            out_ovf[i] = covf;
            cid += want[i] != 0;
        }
        if (threadIdx.x == 0) {
            long long nc = static_cast<long long>(nc0) + total;
            *nc_ptr = static_cast<int>(nc < ccap ? nc : ccap);
        }
    } else {
        // node rows: children's masks are read before any row is written
        for (long long i = lo; i < hi; ++i) {
            out_ids[i] = arena_node_cls(ar, arg_ptr<const int32_t>(a, K3_OP)[i],
                                        arg_ptr<const int32_t>(a, K3_A)[i],
                                        arg_ptr<const int32_t>(a, K3_B)[i],
                                        arg_ptr<const int32_t>(a, K3_C)[i],
                                        arg_ptr<const int32_t>(a, K3_IMM)[i]);
            out_ovf[i] = 0;
        }
    }

    const int n0 = *n_ptr;
    int count = 0;
    for (long long i = lo; i < hi; ++i) count += want[i] && !out_ovf[i];
    long long id = static_cast<long long>(n0)
                   + block_exclusive_scan(count, scan_buf, &total);
    for (long long i = lo; i < hi; ++i) {
        const bool covf = out_ovf[i];
        if (!want[i] || covf) {
            out_ids[i] = 0;
            continue;
        }
        const bool ovf = id >= cap;
        if (!ovf) {
            if (values)
                arena_put_node(ar, id, ARENA_CONST_TAG, 0, 0, 0, out_ids[i], 0, 0);
            else
                arena_put_node(ar, id, arg_ptr<const int32_t>(a, K3_OP)[i],
                               arg_ptr<const int32_t>(a, K3_A)[i],
                               arg_ptr<const int32_t>(a, K3_B)[i],
                               arg_ptr<const int32_t>(a, K3_C)[i],
                               arg_ptr<const int32_t>(a, K3_IMM)[i],
                               arg_ptr<const int32_t>(a, K3_IMM2)[i], out_ids[i]);
        }
        out_ids[i] = ovf ? 0 : static_cast<int>(id);
        out_ovf[i] = ovf;
        ++id;
    }
    if (threadIdx.x == 0) {
        long long n = static_cast<long long>(n0) + total;
        *n_ptr = static_cast<int>(n < cap ? n : cap);
    }
}

MTPU_EXPORT int mtpu_arena_alloc(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    if (a.v[K3_BATCH] <= 0) return 1;  // cudaErrorInvalidValue
    MTPU_LAUNCH(arena_alloc_kernel, 1, block_threads(a.v[K3_BATCH]), stream, a);
    return MTPU_LAUNCH_STATUS();
}
