// Kernel K3's allocation rules (mythril_tpu/parallel/arena.py:105
// `alloc_rows`, :146 `alloc_consts`), shared by the standalone allocation
// (arena_alloc.cu) and the four allocations sym_step.cu folds into its
// launches.
//
// An allocation of `total` wanting entries hands the entry of rank r (its
// rank among the wanting entries in lane order, from a scan) the id
// n + r; ids at or past capacity overflow (id 0, no row), and the bump
// pointer saturates at capacity. A const allocation first places the
// entry's word at const-pool index n_const + r (past the pool's capacity:
// overflow, no node), then wraps the placed words in CONST nodes in the
// same order, so a placed word's node rank is its pool rank.
#pragma once

#include "common.cuh"

enum { ARENA_CONST_TAG = 0x100, ARENA_VAR_TAG = 0x101 };

struct ArenaRef {
    int32_t *op, *a, *b, *c, *imm, *imm2, *cls;
    int32_t* const_vals;  // [ccap, 16]
    long long cap, ccap;
};

__device__ __forceinline__ long long arena_clamp(long long v, long long hi) {
    return v < 0 ? 0 : (v > hi ? hi : v);
}

// the class mask of a new node: a VAR's class bit, a CONST's 0, else the
// union of its children's masks (read before the allocation writes any row)
__device__ __forceinline__ int arena_node_cls(const ArenaRef& ar, int op, int a,
                                              int b, int c, int imm) {
    if (op == ARENA_VAR_TAG) return 1 << arena_clamp(imm, 30);
    if (op == ARENA_CONST_TAG) return 0;
    return ar.cls[arena_clamp(a, ar.cap - 1)] | ar.cls[arena_clamp(b, ar.cap - 1)]
           | ar.cls[arena_clamp(c, ar.cap - 1)];
}

__device__ __forceinline__ void arena_put_node(const ArenaRef& ar, long long id,
                                               int op, int a, int b, int c,
                                               int imm, int imm2, int cls) {
    ar.op[id] = op;
    ar.a[id] = a;
    ar.b[id] = b;
    ar.c[id] = c;
    ar.imm[id] = imm;
    ar.imm2[id] = imm2;
    ar.cls[id] = cls;
}

// the node id of the entry of rank r from bump pointer n0, 0 on overflow
__device__ __forceinline__ int arena_node_id(long long n0, long long r,
                                             long long cap, bool* ovf) {
    const long long id = n0 + r;
    *ovf = id >= cap;
    return *ovf ? 0 : static_cast<int>(id);
}

// the bump pointers after a const allocation of `total` entries from
// (*nc, *n): the placed words, then their CONST nodes
__device__ __forceinline__ void arena_const_advance(long long* nc, long long* n,
                                                    long long total, long long cap,
                                                    long long ccap) {
    const long long room = ccap - *nc;
    const long long placed = total < room ? total : (room > 0 ? room : 0);
    *nc = *nc + total < ccap ? *nc + total : ccap;
    *n = *n + placed < cap ? *n + placed : cap;
}
