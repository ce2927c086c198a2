// Kernel K11: one lockstep DPLL transition for every probe lane.
//
// Replaces mythril_tpu/parallel/jax_solver.py:247 `_step` under its
// runners `_get_runner` (384; freeze off) and `_get_batch_runner` (509;
// freeze on: a query stops once one probe is SAT or none is searching).
// One host call (`mtpu_sat_run`) launches a whole chunk of steps, as the
// JAX fori_loop runs inside one jitted runner, and the wrapper captures
// that call as one CUDA graph. A chunk is
//
//   mirror     once: the variable-major copy of the assignment [Q, V1, P]
//              that propagate reads; every later assignment write keeps it
//   then per step:
//   gate       (freeze only) decided[q] from the pre-step status of all of
//              q's probes, before either of the next launches writes one;
//   propagate  a thread per (clause, group of four probes), the groups of
//              a clause on neighbouring threads: one sector of the mirror
//              per literal serves 32 probes. A conflict sets the probe's
//              flag, a unit clause its "unit seen" flag, atomicMax(key[q,
//              p, var], (clause + 1) << 1 | phase) — the highest clause
//              index wins, which is the last write of JAX's tile-ordered
//              scatter — and the var's bit in the probe's bitmap of keyed
//              vars;
//   count      a block per (probe, tile of K11_VT vars; a thread per 16
//              vars, 32 to 256 threads a block), which knows the probe's
//              branch from its flags (conflict > units > SAT > decide)
//              and reads only what the branch needs: the tags of the trail
//              for the last flippable position; the bitmap for the number
//              of keyed vars; the assignment, `order` and the tags for the
//              least free var (first index on ties), the decision level
//              and whether any var is free. Its first block records the
//              probe's branch, trail length and flags for apply;
//   apply      a block per (probe, tile) again: each combines the probe's
//              tile partials in tile order (no block waits on another); the
//              first writes the probe's scalars (the flip or the decision,
//              trail length, status) and zeroes its flags; each appends its
//              tile's implied vars at trail ranks from the earlier tiles'
//              counts plus a block scan (variable order, never the order
//              atomics land in), or clears its part of the trail above the
//              flip, and zeroes the keys and bitmap words it set.
//
// K13, the clause-sharded chunk (mythril_tpu/parallel/jax_solver.py:397
// `_get_sharded_runner`, `_step` with axis_name "clauses"): D shards, each
// with a replica of the state and the mirror and a contiguous block of the
// clause tiles, on its own device or several on one. Per step
//
//   propagate  on every shard (`mtpu_sat_shard_propagate`: the gate, then
//              propagate over the shard's clause range [C0, C1) into the
//              shard's own step scratch, as K11's, then the seal
//              `sat_shard_seal_kernel`, a thread per (probe, bitmap word):
//              it writes the shard's exchange plane, two bitmap words (the
//              keyed vars, and those whose highest clause in the shard
//              implies FALSE) and the conflict and unit flags, and zeroes
//              the keys, words and flags it read);
//   copies     every shard's plane to every other shard;
//   combine    on every shard (`mtpu_sat_shard_resolve`:
//              `sat_shard_combine_kernel`, a thread per (probe, bitmap
//              word), ORs the D planes' words and flags into the step
//              scratch and writes each keyed var the key 2 | TRUE bit,
//              TRUE where no shard's FALSE bit is set: JAX's pmax of the
//              shards' phases; then count and apply).
//
// So the shards of one variable race as in JAX: a FALSE from any shard
// beats a TRUE from another whatever their clause indices. A plane is two
// bits a var and two flags a probe, so the copies move 2 * NW + 2 words a
// probe and no key. With every shard on the caller's card the wrapper
// replays a chunk as one CUDA graph, a stream a shard.
//
// Bound: bytes. A step reads each clause's literals once (12 B) and one
// mirror byte per literal and searching probe, then per probe the branch's
// share of its rows: about 1 µs at the main shape (32 probes, V1 65,536,
// 64 tiles of clauses). There count and apply launch 512 blocks reading
// neighbouring addresses on neighbouring threads, and the step's time is
// propagate's instruction throughput (a thread per clause and four
// probes, 32-bit index math) and the latency of the two resolve launches,
// which do little work each.
#include "common.cuh"

enum { SAT_UNASSIGNED = 0, SAT_TRUE = 1, SAT_FALSE = 2 };
enum { SAT_SEARCHING = 0, SAT_S_SAT = 1, SAT_S_UNSAT = 2 };
enum { SAT_PROP_THREADS = 256, SAT_GATE_THREADS = 128, SAT_TILE_THREADS = 256,
       SAT_MAX_PROBES = 1024 };
enum { BR_NONE = 0, BR_CONFLICT = 1, BR_UNITS = 2, BR_DECIDE = 3 };
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
    int32_t* unit;
    uint32_t* bits;
    int8_t* mirror;
    long long* part64;
    int32_t* part32;
    int32_t* res;
    long long Q, P, V1, C, VT, NT, NW;
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
    s.unit = arg_ptr<int32_t>(a, K11_UNIT);
    s.bits = arg_ptr<uint32_t>(a, K11_BITS);
    s.mirror = arg_ptr<int8_t>(a, K11_MIRROR);
    s.part64 = arg_ptr<long long>(a, K11_PART64);
    s.part32 = arg_ptr<int32_t>(a, K11_PART32);
    s.res = arg_ptr<int32_t>(a, K11_RES);
    s.Q = a.v[K11_Q];
    s.P = a.v[K11_P];
    s.V1 = a.v[K11_V1];
    s.C = a.v[K11_C];
    s.VT = a.v[K11_VT];
    s.NT = (s.V1 + s.VT - 1) / s.VT;
    s.NW = (s.V1 + 31) / 32;
    s.forced_depth = arg_int(a, K11_FORCED_DEPTH);
    return s;
}

__device__ __forceinline__ int sat_abs(int x) { return x < 0 ? -x : x; }

__device__ __forceinline__ long long sat_min(long long x, long long y) { return x < y ? x : y; }

// the probe steps this step: searching, and its query not frozen (read
// before the step's apply launch writes a status)
__device__ __forceinline__ bool sat_active(const SatView& s, long long row) {
    return (s.decided == nullptr || s.decided[row / s.P] == 0)
           && s.status[row] == SAT_SEARCHING;
}

// assign[row, v] and its mirror byte
__device__ __forceinline__ void sat_set(const SatView& s, long long row, long long v, int8_t value) {
    s.assign[row * s.V1 + v] = value;
    const long long q = row / s.P, p = row % s.P;
    s.mirror[(q * s.V1 + v) * s.P + p] = value;
}

// the block's sum of one value per thread (every thread calls it and gets
// the sum; blockDim.x a power of two)
__device__ __forceinline__ long long block_sum(long long value, long long* buf) {
    const int t = threadIdx.x;
    buf[t] = value;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        if (t < half) buf[t] += buf[t + half];
        __syncthreads();
    }
    const long long out = buf[0];
    __syncthreads();
    return out;
}

// blocks [q * per_query, (q + 1) * per_query) of a launch over Q queries
// serve query q; returns the block's index within its query
__device__ __forceinline__ long long query_block(long long n, long long* q) {
    const long long per_query = (n + blockDim.x - 1) / blockDim.x;
    *q = blockIdx.x / per_query;
    return blockIdx.x % per_query;
}

__global__ void sat_mirror_kernel(Args a) {
    const SatView s = sat_view(a);
    const long long n = s.V1 * s.P;
    long long q;
    const long long i = query_block(n, &q) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const long long v = i / s.P, p = i % s.P;
    s.mirror[q * n + i] = s.assign[(q * s.P + p) * s.V1 + v];
}

__device__ __forceinline__ void sat_gate(const SatView& s, long long q) {
    int any_sat = 0, all_done = 1;
    for (long long p = 0; p < s.P; ++p) {
        const int8_t st = s.status[q * s.P + p];
        any_sat |= st == SAT_S_SAT;
        all_done &= st != SAT_SEARCHING;
    }
    s.decided[q] = any_sat | all_done;
}

__global__ void sat_gate_kernel(Args a) {
    const SatView s = sat_view(a);
    const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (q < s.Q) sat_gate(s, q);
}

// what one thread reads of a mirror row: PPT neighbouring probes' bytes
template <int PPT> struct SatWord;
template <> struct SatWord<1> { typedef uint8_t T; };
template <> struct SatWord<4> { typedef uint32_t T; };

// a thread per (clause, group of PPT probes): one load of the mirror per
// literal serves the group, 32-bit index arithmetic only
template <int PPT>
__global__ void sat_propagate_kernel(Args a) {
    typedef typename SatWord<PPT>::T Word;
    const SatView s = sat_view(a);
    const unsigned bpq = static_cast<unsigned>(a.v[K11_PROP_BPQ]);
    const unsigned shift = static_cast<unsigned>(a.v[K11_PROP_SHIFT]);
    const unsigned q = blockIdx.x / bpq;
    const unsigned i = (blockIdx.x - q * bpq) * blockDim.x + threadIdx.x;
    const unsigned c = static_cast<unsigned>(a.v[K11_C0]) + (i >> shift);
    const unsigned p0 = (i & ((1u << shift) - 1)) * PPT;
    if (c >= a.v[K11_C1] || p0 >= s.P || !s.valid[q * s.C + c]) return;
    if (s.decided != nullptr && s.decided[q] != 0) return;
    // the group's searching probes (status SAT_SEARCHING is byte 0)
    const Word status = *reinterpret_cast<const Word*>(s.status + q * s.P + p0);
    unsigned active = 0;
    for (int j = 0; j < PPT; ++j)
        active |= static_cast<unsigned>(((status >> (8 * j)) & 0xFF) == SAT_SEARCHING) << j;
    if (!active) return;
    const int32_t* clause = s.lits + (q * s.C + c) * 3;
    const int8_t* mirror = s.mirror + q * s.V1 * s.P + p0;
    int lit[3];
    Word value[3];
    for (int k = 0; k < 3; ++k) {
        lit[k] = clause[k];
        value[k] = lit[k] == 0 ? 0
                   : *reinterpret_cast<const Word*>(mirror + static_cast<long long>(sat_abs(lit[k])) * s.P);
    }
    for (int j = 0; j < PPT; ++j) {
        if (!((active >> j) & 1)) continue;
        bool sat = false;
        int n_unassigned = 0, unit = 0;
        for (int k = 0; k < 3; ++k) {
            if (lit[k] == 0) continue;
            const int v = (value[k] >> (8 * j)) & 0xFF;
            if (v == SAT_UNASSIGNED) {
                if (n_unassigned++ == 0) unit = lit[k];
            } else if ((v == SAT_TRUE) == (lit[k] > 0)) {
                sat = true;
                break;
            }
        }
        if (sat) continue;
        const long long row = q * s.P + p0 + j;
        if (n_unassigned == 0) {
            s.conflict[row] = 1;
        } else if (n_unassigned == 1) {
            const long long v = sat_abs(unit);
            atomicMax(s.key + row * s.V1 + v,
                      static_cast<int>((c + 1) << 1) | (unit > 0 ? 1 : 0));
            atomicOr(s.bits + row * s.NW + v / 32, 1u << (v % 32));
            if (!s.unit[row]) s.unit[row] = 1;
        }
    }
}

__global__ void sat_count_kernel(Args a) {
    const SatView s = sat_view(a);
    __shared__ long long buf[SAT_TILE_THREADS];
    const long long row = blockIdx.x / s.NT, tile = blockIdx.x % s.NT;
    const bool active = sat_active(s, row);
    if (tile == 0 && threadIdx.x == 0) {
        // the step's record of the probe, which apply reads while its first
        // block rewrites the flags and the trail length
        int32_t* res = s.res + row * N_SAT_RES;
        res[SAT_RES_BRANCH] = !active ? BR_NONE
                              : (s.conflict[row] ? BR_CONFLICT : (s.unit[row] ? BR_UNITS : BR_DECIDE));
        res[SAT_RES_LEN] = s.trail_len[row];
        res[SAT_RES_CLEAR] = active && s.unit[row];
    }
    if (!active) return;  // uniform over the block
    const long long V1 = s.V1, t = threadIdx.x;
    const long long lo = tile * s.VT, hi = sat_min(lo + s.VT, V1);
    const long long in_trail = sat_min(V1, s.trail_len[row] < 0 ? 0 : s.trail_len[row]);
    const int8_t* assign = s.assign + row * V1;
    const int8_t* tag = s.tag + row * V1;
    long long wide = 0, narrow = 0, extra = 0;
    if (s.conflict[row]) {
        // the last flippable decision in this tile's part of the trail
        long long flip = -1;
        for (long long pos = lo + t; pos < sat_min(hi, in_trail); pos += blockDim.x)
            if (tag[pos] == 1) flip = pos;
        wide = block_max(flip, buf);
    } else if (s.unit[row]) {
        // keyed vars (each unassigned: its unit clause's one open literal)
        long long n = 0;
        const uint32_t* bits = s.bits + row * s.NW;
        for (long long w = lo / 32 + t; w < (hi + 31) / 32; w += blockDim.x)
            n += __popc(bits[w]);
        narrow = block_sum(n, buf);
    } else {
        // the least (order, var) over all vars (a var not free ranks
        // SAT_NOT_FREE), whether one is free, and the decisions on the trail
        long long pick = SAT_NO_PICK, level = 0, any_free = 0;
        const int32_t* order = s.order + (row / s.P) * V1;
        for (long long v = lo + t; v < hi; v += blockDim.x) {
            const bool free_var = v != 0 && assign[v] == SAT_UNASSIGNED;
            any_free |= free_var;
            const long long rank = free_var ? order[v] : SAT_NOT_FREE;
            pick = sat_min(pick, (rank << 32) | v);
            level += v < in_trail && tag[v] >= 1;
        }
        narrow = block_sum(level, buf);
        extra = block_sum(any_free, buf);
        wide = -block_max(-pick, buf);
    }
    if (t == 0) {
        s.part64[row * s.NT + tile] = wide;
        s.part32[(row * s.NT + tile) * 2] = static_cast<int32_t>(narrow);
        s.part32[(row * s.NT + tile) * 2 + 1] = static_cast<int32_t>(extra != 0);
    }
}

// what every block of a probe takes from the probe's tile partials (the
// same combination in each block, in tile order)
struct SatRow {
    long long pick;  // conflict: the flip position (-1: none); decide: the key
    long long below, total;  // units: keyed vars in earlier tiles, in all
    long long level, flip_var;
    bool any_free;
};

__device__ SatRow sat_combine(const SatView& s, long long row, long long tile, int branch) {
    const long long* wide = s.part64 + row * s.NT;
    const int32_t* narrow = s.part32 + row * s.NT * 2;
    SatRow r = {branch == BR_CONFLICT ? -1 : SAT_NO_PICK, 0, 0, 0, -1, false};
    for (long long k = 0; k < s.NT; ++k) {
        if (branch == BR_CONFLICT) {
            r.pick = wide[k] > r.pick ? wide[k] : r.pick;
        } else if (branch == BR_UNITS) {
            if (k < tile) r.below += narrow[2 * k];
            r.total += narrow[2 * k];
        } else {
            r.pick = sat_min(r.pick, wide[k]);
            r.level += narrow[2 * k];
            r.any_free = r.any_free || narrow[2 * k + 1];
        }
    }
    return r;
}

// the probe's scalars, written by its first block: the flip, the appended
// length, SAT, or the decision; the flags back to zero
__device__ void sat_settle(const SatView& s, long long row, int branch, long long len,
                           const SatRow& r) {
    const long long V1 = s.V1;
    int32_t* trail = s.trail + row * V1;
    int8_t* tag = s.tag + row * V1;
    if (branch == BR_CONFLICT) {
        // backtrack to the last flippable decision (none: position 0, and
        // the probe's cube is refuted)
        const bool has_flip = r.pick >= 0;
        const long long pos = has_flip ? r.pick : 0;
        const int flip_lit = trail[pos];
        if (has_flip) sat_set(s, row, sat_abs(flip_lit), flip_lit > 0 ? SAT_FALSE : SAT_TRUE);
        trail[pos] = -flip_lit;
        tag[pos] = 2;
        s.trail_len[row] = static_cast<int32_t>(has_flip ? pos + 1 : len);
        s.status[row] = has_flip ? SAT_SEARCHING : SAT_S_UNSAT;
    } else if (branch == BR_UNITS) {
        s.trail_len[row] = static_cast<int32_t>(len + r.total);
    } else if (!r.any_free) {
        s.status[row] = SAT_S_SAT;
    } else {
        // decide: the forced cube prefix first, then FALSE
        const long long p = row % s.P;
        const int d_var = static_cast<int>(r.pick & 0xFFFFFFFFLL);
        const bool in_prefix = r.level < s.forced_depth;
        const int shift = r.level > 30 ? 30 : static_cast<int>(r.level);
        const bool phase_true = in_prefix && ((p >> shift) & 1);
        sat_set(s, row, d_var, phase_true ? SAT_TRUE : SAT_FALSE);
        const long long d_pos = len < 0 ? 0 : (len > V1 - 1 ? V1 - 1 : len);
        trail[d_pos] = phase_true ? d_var : -d_var;
        tag[d_pos] = in_prefix ? 2 : 1;
        s.trail_len[row] = static_cast<int32_t>(len + 1);
    }
    s.conflict[row] = 0;
    s.unit[row] = 0;
}

__global__ void sat_apply_kernel(Args a) {
    const SatView s = sat_view(a);
    __shared__ int buf[SAT_TILE_THREADS];
    __shared__ SatRow shared_row;
    const long long row = blockIdx.x / s.NT, tile = blockIdx.x % s.NT;
    const int32_t* res = s.res + row * N_SAT_RES;
    const int branch = res[SAT_RES_BRANCH];
    if (branch == BR_NONE) return;  // uniform over the block
    const long long V1 = s.V1, t = threadIdx.x, len = res[SAT_RES_LEN];
    int32_t* trail = s.trail + row * V1;
    if (t == 0) {
        shared_row = sat_combine(s, row, tile, branch);
        // the flipped var, read before the first block negates its entry
        if (branch == BR_CONFLICT && shared_row.pick >= 0)
            shared_row.flip_var = sat_abs(trail[shared_row.pick]);
        if (tile == 0) sat_settle(s, row, branch, len, shared_row);
    }
    __syncthreads();
    const SatRow r = shared_row;
    const long long lo = tile * s.VT, hi = sat_min(lo + s.VT, V1);
    int32_t* key = s.key + row * V1;
    if (branch == BR_UNITS || res[SAT_RES_CLEAR]) {
        // this thread's run of the tile's bitmap words
        uint32_t* bits = s.bits + row * s.NW;
        const long long w0 = lo / 32, n_words = (hi + 31) / 32 - w0;
        const long long per = (n_words + blockDim.x - 1) / blockDim.x;
        const long long first = w0 + sat_min(t * per, n_words);
        const long long last = w0 + sat_min(t * per + per, n_words);
        int count = 0;
        for (long long w = first; w < last; ++w) count += __popc(bits[w]);
        int total;
        long long rank = block_exclusive_scan(count, buf, &total) + len + r.below;
        for (long long w = first; w < last; ++w) {
            for (uint32_t word = bits[w]; word; word &= word - 1) {
                const long long v = w * 32 + __ffs(word) - 1;
                const int k = key[v];
                key[v] = 0;
                if (branch != BR_UNITS) continue;
                // assert the implied literal, appended in variable order
                const bool phase_true = (k & 1) != 0;
                sat_set(s, row, v, phase_true ? SAT_TRUE : SAT_FALSE);
                if (rank < V1) {
                    trail[rank] = static_cast<int32_t>(phase_true ? v : -v);
                    s.tag[row * V1 + rank] = 0;
                }
                ++rank;
            }
            bits[w] = 0;
        }
    }
    if (branch == BR_CONFLICT) {
        // unassign the trail above the flip (the flipped var keeps the new
        // phase the first block gives it, as JAX sets it after the clear)
        const long long from = (r.pick >= 0 ? r.pick : 0) + 1;
        const long long to = sat_min(hi, sat_min(len, V1));
        for (long long i = (from > lo ? from : lo) + t; i < to; i += blockDim.x) {
            const int var = sat_abs(trail[i]);
            if (var != r.flip_var) sat_set(s, row, var, SAT_UNASSIGNED);
        }
    }
}

// K13's plane of one shard: int32 [2 * Q * P * NW + 2 * Q * P] (layout.cuh
// K11_XCHG)
__device__ __forceinline__ long long sat_plane(const SatView& s) {
    return 2 * s.Q * s.P * (s.NW + 1);
}

// K13's seal: a thread per (probe row, bitmap word) of every query. It
// reads the shard's bitmap word and, for each var keyed there, the shard's
// key (its highest clause's), and writes into the shard's own plane the
// word, the word of the vars whose key is FALSE and, in its row's first
// word's thread, the two flags. It zeroes what it read, so the step
// scratch is zero again for the combine, as K11 leaves it.
__global__ void sat_shard_seal_kernel(Args a) {
    const SatView s = sat_view(a);
    const long long rows = s.Q * s.P, words = rows * s.NW;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= words) return;
    const long long row = i / s.NW, w = i % s.NW;
    uint32_t* own = arg_ptr<uint32_t>(a, K11_XCHG) + a.v[K11_SHARD] * sat_plane(s);
    const uint32_t word = s.bits[i];
    uint32_t false_word = 0;
    if (word) {
        int32_t* key = s.key + row * s.V1 + w * 32;
        for (uint32_t left = word; left; left &= left - 1) {
            const int b = __ffs(left) - 1;
            false_word |= static_cast<uint32_t>((key[b] & 1) == 0) << b;
            key[b] = 0;
        }
        s.bits[i] = 0;
    }
    own[i] = word;
    own[words + i] = false_word;
    if (w == 0) {
        own[2 * words + row] = static_cast<uint32_t>(s.conflict[row]);
        own[2 * words + rows + row] = static_cast<uint32_t>(s.unit[row]);
        s.conflict[row] = 0;
        s.unit[row] = 0;
    }
}

// K13's combine: a thread per (probe row, bitmap word) of every query. It
// ORs the word and the FALSE word of each of the D planes, writes the word
// into the step scratch (zero on entry: the seal left it so) and each of
// its vars the key 2 | TRUE bit (all apply reads of a key), and in its
// row's first word's thread the ORs of the flags. It reads no key.
__global__ void sat_shard_combine_kernel(Args a) {
    const SatView s = sat_view(a);
    const long long rows = s.Q * s.P, words = rows * s.NW;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= words) return;
    const long long row = i / s.NW, w = i % s.NW;
    const long long plane = sat_plane(s), n_shards = a.v[K11_SHARDS];
    const uint32_t* xchg = arg_ptr<const uint32_t>(a, K11_XCHG);
    uint32_t word = 0, false_word = 0;
    for (long long d = 0; d < n_shards; ++d) {
        word |= xchg[d * plane + i];
        false_word |= xchg[d * plane + words + i];
    }
    if (word) {
        s.bits[i] = word;
        int32_t* key = s.key + row * s.V1 + w * 32;
        for (uint32_t left = word; left; left &= left - 1) {
            const int b = __ffs(left) - 1;
            key[b] = 2 | static_cast<int>(((false_word >> b) & 1) ^ 1);
        }
    }
    if (w == 0) {
        uint32_t conflict = 0, unit = 0;
        for (long long d = 0; d < n_shards; ++d) {
            conflict |= xchg[d * plane + 2 * words + row];
            unit |= xchg[d * plane + 2 * words + rows + row];
        }
        s.conflict[row] = conflict != 0;
        s.unit[row] = unit != 0;
    }
}

// the launch geometry of a chunk's kernels, checked; propagate's (over the
// clause range [C0, C1)) goes into the block. Returns 0, or 1 for a shape
// the kernels do not take (cudaErrorInvalidValue).
struct SatGrid {
    int ppt, tiles, tile_threads, gate_blocks, prop_blocks, mirror_blocks;
};

static int sat_grid(Args& a, SatGrid* g) {
    const long long Q = a.v[K11_Q], P = a.v[K11_P], V1 = a.v[K11_V1], C = a.v[K11_C];
    const long long VT = a.v[K11_VT], C0 = a.v[K11_C0], C1 = a.v[K11_C1];
    if (Q <= 0 || P <= 0 || P > SAT_MAX_PROBES || V1 < 2 || V1 > (1LL << 31)
        || C <= 0 || C >= (1LL << 30) || C * P >= (1LL << 30) || VT < 32 || (VT & (VT - 1))
        || C0 < 0 || C1 <= C0 || C1 > C)
        return 1;
    const long long NT = (V1 + VT - 1) / VT;
    if (Q * P * NT > 0x7FFFFFFFLL) return 1;
    // four probes a thread where the probe count allows aligned 32-bit loads
    g->ppt = P % 4 == 0 ? 4 : 1;
    int shift = 0;
    while ((1LL << shift) < P / g->ppt) ++shift;
    const long long bpq = (((C1 - C0) << shift) + SAT_PROP_THREADS - 1) / SAT_PROP_THREADS;
    a.v[K11_PROP_SHIFT] = shift;
    a.v[K11_PROP_BPQ] = bpq;
    const long long prop_blocks = Q * bpq;
    const long long mirror_blocks = Q * ((V1 * P + SAT_PROP_THREADS - 1) / SAT_PROP_THREADS);
    if (prop_blocks > 0x7FFFFFFFLL || mirror_blocks > 0x7FFFFFFFLL) return 1;
    g->prop_blocks = static_cast<int>(prop_blocks);
    g->mirror_blocks = static_cast<int>(mirror_blocks);
    g->tiles = static_cast<int>(Q * P * NT);
    g->tile_threads = static_cast<int>(
        VT / 16 < 32 ? 32 : (VT / 16 > SAT_TILE_THREADS ? SAT_TILE_THREADS : VT / 16));
    g->gate_blocks = static_cast<int>((Q + SAT_GATE_THREADS - 1) / SAT_GATE_THREADS);
    return 0;
}

static void sat_propagate(const Args& a, const SatGrid& g, void* stream) {
    if (a.v[K11_DECIDED] != 0)
        MTPU_LAUNCH(sat_gate_kernel, g.gate_blocks, SAT_GATE_THREADS, stream, a);
    if (g.ppt == 4)
        MTPU_LAUNCH(sat_propagate_kernel<4>, g.prop_blocks, SAT_PROP_THREADS, stream, a);
    else
        MTPU_LAUNCH(sat_propagate_kernel<1>, g.prop_blocks, SAT_PROP_THREADS, stream, a);
}

static void sat_resolve(const Args& a, const SatGrid& g, void* stream) {
    MTPU_LAUNCH(sat_count_kernel, g.tiles, g.tile_threads, stream, a);
    MTPU_LAUNCH(sat_apply_kernel, g.tiles, g.tile_threads, stream, a);
}

MTPU_EXPORT int mtpu_sat_run(const long long* values, int n, void* stream) {
    Args a = mtpu_pack(values, n);
    a.v[K11_C0] = 0;
    a.v[K11_C1] = a.v[K11_C];
    SatGrid g;
    if (sat_grid(a, &g)) return 1;
    MTPU_LAUNCH(sat_mirror_kernel, g.mirror_blocks, SAT_PROP_THREADS, stream, a);
    int rc = MTPU_LAUNCH_STATUS();
    for (long long step = 0; step < a.v[K11_STEPS] && !rc; ++step) {
        sat_propagate(a, g, stream);
        sat_resolve(a, g, stream);
        rc = MTPU_LAUNCH_STATUS();
    }
    return rc;
}

// K13's entries, one shard's block each: the chunk's mirror; a step's gate,
// propagate and seal into the shard's own exchange plane; a step's combine
// of the planes (copied in by the wrapper) and its count and apply
static int sat_shard_args(const long long* values, int n, Args* a, SatGrid* g) {
    *a = mtpu_pack(values, n);
    const long long D = a->v[K11_SHARDS], shard = a->v[K11_SHARD];
    if (D < 1 || shard < 0 || shard >= D || a->v[K11_XCHG] == 0) return 1;
    return sat_grid(*a, g);
}

MTPU_EXPORT int mtpu_sat_shard_mirror(const long long* values, int n, void* stream) {
    Args a;
    SatGrid g;
    if (sat_shard_args(values, n, &a, &g)) return 1;
    MTPU_LAUNCH(sat_mirror_kernel, g.mirror_blocks, SAT_PROP_THREADS, stream, a);
    return MTPU_LAUNCH_STATUS();
}

// a launch of a thread per (probe, bitmap word), checked
static int sat_word_blocks(const Args& a, int* blocks) {
    const long long words = a.v[K11_Q] * a.v[K11_P] * ((a.v[K11_V1] + 31) / 32);
    const long long n = (words + SAT_PROP_THREADS - 1) / SAT_PROP_THREADS;
    if (n > 0x7FFFFFFFLL) return 1;
    *blocks = static_cast<int>(n);
    return 0;
}

MTPU_EXPORT int mtpu_sat_shard_propagate(const long long* values, int n, void* stream) {
    Args a;
    SatGrid g;
    int blocks;
    if (sat_shard_args(values, n, &a, &g) || sat_word_blocks(a, &blocks)) return 1;
    sat_propagate(a, g, stream);
    MTPU_LAUNCH(sat_shard_seal_kernel, blocks, SAT_PROP_THREADS, stream, a);
    return MTPU_LAUNCH_STATUS();
}

MTPU_EXPORT int mtpu_sat_shard_resolve(const long long* values, int n, void* stream) {
    Args a;
    SatGrid g;
    int blocks;
    if (sat_shard_args(values, n, &a, &g) || sat_word_blocks(a, &blocks)) return 1;
    MTPU_LAUNCH(sat_shard_combine_kernel, blocks, SAT_PROP_THREADS, stream, a);
    sat_resolve(a, g, stream);
    return MTPU_LAUNCH_STATUS();
}

// load every kernel of this source (before a CUDA graph captures them)
MTPU_EXPORT int mtpu_sat_preload(const long long*, int, void*) {
    return MTPU_PRELOAD(sat_mirror_kernel) | MTPU_PRELOAD(sat_gate_kernel)
           | MTPU_PRELOAD(sat_propagate_kernel<1>) | MTPU_PRELOAD(sat_propagate_kernel<4>)
           | MTPU_PRELOAD(sat_count_kernel) | MTPU_PRELOAD(sat_apply_kernel)
           | MTPU_PRELOAD(sat_shard_seal_kernel) | MTPU_PRELOAD(sat_shard_combine_kernel);
}
