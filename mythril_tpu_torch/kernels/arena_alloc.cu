// Kernel K3: arena node and constant allocation, one block of one thread
// per lane.
//
// Replaces mythril_tpu/parallel/arena.py:105 `alloc_rows` and :146
// `alloc_consts`. Every wanting lane appends one node: its id is the bump
// pointer `n` plus the lane's rank among the wanting lanes, taken from a
// block-wide exclusive scan and never from atomics, so ids and lane order
// equal the JAX package's. Lanes past capacity get id 0 and an overflow
// flag; the pointer saturates at capacity (arena.py:136,168). A VAR node's
// `cls` is its class bit, a CONST node's 0, any other node's the union of
// its children's masks, read before this call writes anything. In const
// mode (`values` given) the words first go to the const pool the same way
// and the CONST nodes wrap them. The arena is updated in place.
//
// Bound: bytes (a few int32 per lane, plus one 64-byte word per const);
// the scan makes it a single block, so B is at most 1024 lanes.
#include "common.cuh"

namespace {

enum { VAR_TAG = 0x101, CONST_TAG = 0x100 };

__device__ __forceinline__ int clampi(long long v, int hi) {
    return static_cast<int>(v < 0 ? 0 : (v > hi ? hi : v));
}

}  // namespace

__global__ void arena_alloc_kernel(Args a) {
    __shared__ int scan_buf[1024];
    const int lane = threadIdx.x;
    const bool active = lane < arg_int(a, K3_BATCH);
    const uint8_t* want_p = arg_ptr<const uint8_t>(a, K3_WANT);
    bool want = active && want_p[lane];
    bool overflow = false;

    int* n_ptr = arg_ptr<int>(a, K3_N);
    const int cap = arg_int(a, K3_CAP);
    int32_t* cls_col = arg_ptr<int32_t>(a, K3_COL_CLS);

    int op = 0, ca = 0, cb = 0, cc = 0, imm = 0, imm2 = 0;
    const int32_t* values = arg_ptr<const int32_t>(a, K3_VALUES);
    int total;
    if (values) {
        // const pool: append the lane's word at n_const + rank
        int* nc_ptr = arg_ptr<int>(a, K3_N_CONST);
        const int ccap = arg_int(a, K3_CCAP);
        const int nc0 = *nc_ptr;
        const int crank = block_exclusive_scan(want ? 1 : 0, scan_buf, &total);
        const long long cid = static_cast<long long>(nc0) + crank;
        const bool covf = want && cid >= ccap;
        if (want && !covf) {
            int32_t* dst = arg_ptr<int32_t>(a, K3_CONST_VALS) + cid * 16;
            for (int i = 0; i < 16; ++i) dst[i] = values[16LL * lane + i];
        }
        __syncthreads();
        if (lane == 0) {
            long long nc = static_cast<long long>(nc0) + total;
            *nc_ptr = static_cast<int>(nc < ccap ? nc : ccap);
        }
        overflow = covf;
        want = want && !covf;
        op = CONST_TAG;
        imm = static_cast<int>(cid);
    } else if (active) {
        op = arg_ptr<const int32_t>(a, K3_OP)[lane];
        ca = arg_ptr<const int32_t>(a, K3_A)[lane];
        cb = arg_ptr<const int32_t>(a, K3_B)[lane];
        cc = arg_ptr<const int32_t>(a, K3_C)[lane];
        imm = arg_ptr<const int32_t>(a, K3_IMM)[lane];
        imm2 = arg_ptr<const int32_t>(a, K3_IMM2)[lane];
    }

    // node rows: children's masks are read before any row is written
    int cls = 0;
    if (active) {
        if (op == VAR_TAG) cls = 1 << clampi(imm, 30);
        else if (op != CONST_TAG)
            cls = cls_col[clampi(ca, cap - 1)] | cls_col[clampi(cb, cap - 1)]
                  | cls_col[clampi(cc, cap - 1)];
    }
    const int n0 = *n_ptr;
    const int rank = block_exclusive_scan(want ? 1 : 0, scan_buf, &total);
    const long long id = static_cast<long long>(n0) + rank;
    const bool ovf = want && id >= cap;
    const bool ok = want && !ovf;
    if (ok) {
        arg_ptr<int32_t>(a, K3_COL_OP)[id] = op;
        arg_ptr<int32_t>(a, K3_COL_A)[id] = ca;
        arg_ptr<int32_t>(a, K3_COL_B)[id] = cb;
        arg_ptr<int32_t>(a, K3_COL_C)[id] = cc;
        arg_ptr<int32_t>(a, K3_COL_IMM)[id] = imm;
        arg_ptr<int32_t>(a, K3_COL_IMM2)[id] = imm2;
        cls_col[id] = cls;
    }
    if (lane == 0) {
        long long n = static_cast<long long>(n0) + total;
        *n_ptr = static_cast<int>(n < cap ? n : cap);
    }
    if (active) {
        arg_ptr<int32_t>(a, K3_OUT_IDS)[lane] = ok ? static_cast<int>(id) : 0;
        arg_ptr<uint8_t>(a, K3_OUT_OVF)[lane] = ovf || overflow;
    }
}

MTPU_EXPORT int mtpu_arena_alloc(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    const int batch = static_cast<int>(a.v[K3_BATCH]);
    if (batch <= 0 || batch > 1024) return 1;  // cudaErrorInvalidValue
    int threads = 32;
    while (threads < batch) threads <<= 1;
    MTPU_LAUNCH(arena_alloc_kernel, 1, threads, stream, a);
    return MTPU_LAUNCH_STATUS();
}
