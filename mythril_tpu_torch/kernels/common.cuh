// Shared plumbing of the port's CUDA kernels (sm_90a).
//
// Every kernel takes one parameter block `Args`: a flat array of 64-bit
// slots holding device pointers and sizes at the fixed indices named in
// layout.cuh (mirrored by kernels/layout.py). The host entry point of each
// source copies the caller's array into the block, launches on the given
// stream and returns the cudaError_t of the launch (0 = launched).
#pragma once

#include <stdint.h>

#ifndef MTPU_LAUNCH
#include <cuda_runtime.h>
#define MTPU_LAUNCH(kernel, grid, block, stream, args) \
    kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(args)
#define MTPU_LAUNCH_STATUS() ((int)cudaGetLastError())
// load a kernel's code now (the runtime loads lazily, at the first launch,
// which should not fall inside a CUDA graph capture); 0 = loaded
template <class F>
static inline int mtpu_preload(F* kernel) {
    cudaFuncAttributes attr;
    return (int)cudaFuncGetAttributes(&attr, kernel);
}
#define MTPU_PRELOAD(kernel) mtpu_preload(kernel)
#endif

#define MTPU_EXPORT extern "C" __attribute__((visibility("default")))

// a device function kept out of line, so that its registers do not set
// those of the code around its call (the host build inlines as it likes)
#ifdef __CUDACC__
#define MTPU_NOINLINE __noinline__
#else
#define MTPU_NOINLINE
#endif

#include "layout.cuh"

struct Args {
    long long v[MTPU_MAX_ARGS];
};

static inline Args mtpu_pack(const long long* values, int n) {
    Args a;
    for (int i = 0; i < MTPU_MAX_ARGS; ++i) a.v[i] = i < n ? values[i] : 0;
    return a;
}

template <class T>
__device__ __forceinline__ T* arg_ptr(const Args& a, int i) {
    return reinterpret_cast<T*>(static_cast<uintptr_t>(a.v[i]));
}

__device__ __forceinline__ int arg_int(const Args& a, int i) {
    return static_cast<int>(a.v[i]);
}

// lane status values (batch.py)
enum {
    ST_RUNNING = 0, ST_STOPPED = 1, ST_RETURNED = 2, ST_REVERTED = 3,
    ST_ERRORED = 4, ST_ESCAPED = 5, ST_FORKING = 6, ST_DEAD = 7
};

// opcode table rows: int32[256][4] = {pops, pushes, gas_min, flags}
enum { OPT_POPS = 0, OPT_PUSHES = 1, OPT_GAS = 2, OPT_FLAGS = 3 };
enum {
    OPF_VALID = 1, OPF_ESCAPE = 2, OPF_SYM_OK = 4, OPF_PLUMBING = 8
};
#define OPF_ENV_CLASS(flags) (((flags) >> 8) & 0xFF)
// telemetry op class (symstep.OP_CLASS) in bits 16..23
#define OPF_OP_CLASS(flags) (((flags) >> 16) & 0xFF)

// telemetry plane sizes (symstep.py N_OP_CLASSES, N_LIFECYCLE, N_ESC_CAUSES)
enum { N_OP_CLASSES = 15, N_LIFECYCLE = 12, N_ESC_CAUSES = 8,
       MAX_TEL_SLOTS = 64 };

// opcode bytes the kernels test directly
enum {
    OP_STOP = 0x00, OP_ADD = 0x01, OP_MUL = 0x02, OP_SUB = 0x03,
    OP_DIV = 0x04, OP_SDIV = 0x05, OP_MOD = 0x06, OP_SMOD = 0x07,
    OP_ADDMOD = 0x08, OP_MULMOD = 0x09, OP_EXP = 0x0A, OP_SIGNEXTEND = 0x0B,
    OP_LT = 0x10, OP_GT = 0x11, OP_SLT = 0x12, OP_SGT = 0x13, OP_EQ = 0x14,
    OP_ISZERO = 0x15, OP_AND = 0x16, OP_OR = 0x17, OP_XOR = 0x18,
    OP_NOT = 0x19, OP_BYTE = 0x1A, OP_SHL = 0x1B, OP_SHR = 0x1C,
    OP_SAR = 0x1D, OP_SHA3 = 0x20, OP_ADDRESS = 0x30, OP_ORIGIN = 0x32,
    OP_CALLER = 0x33, OP_CALLVALUE = 0x34, OP_CALLDATALOAD = 0x35,
    OP_CALLDATASIZE = 0x36, OP_CALLDATACOPY = 0x37, OP_CODESIZE = 0x38,
    OP_CODECOPY = 0x39, OP_GASPRICE = 0x3A, OP_RETURNDATASIZE = 0x3D,
    OP_RETURNDATACOPY = 0x3E, OP_COINBASE = 0x41, OP_TIMESTAMP = 0x42,
    OP_NUMBER = 0x43, OP_PREVRANDAO = 0x44, OP_GASLIMIT = 0x45,
    OP_CHAINID = 0x46, OP_SELFBALANCE = 0x47, OP_BASEFEE = 0x48,
    OP_BLOBHASH = 0x49, OP_BLOBBASEFEE = 0x4A, OP_POP = 0x50,
    OP_MLOAD = 0x51, OP_MSTORE = 0x52, OP_MSTORE8 = 0x53, OP_SLOAD = 0x54,
    OP_SSTORE = 0x55, OP_JUMP = 0x56, OP_JUMPI = 0x57, OP_PC = 0x58,
    OP_MSIZE = 0x59, OP_GAS = 0x5A, OP_JUMPDEST = 0x5B, OP_TLOAD = 0x5C,
    OP_TSTORE = 0x5D, OP_MCOPY = 0x5E, OP_PUSH0 = 0x5F, OP_RETURN = 0xF3,
    OP_REVERT = 0xFD, OP_INVALID = 0xFE
};

// Block-wide exclusive prefix sum of one value per thread (Hillis-Steele
// over shared memory; blockDim.x <= 1024, `buf` one slot per thread).
// Returns the thread's exclusive rank; *total receives the block sum. Every
// thread of the block must call it. Ranks come from the scan, never from
// atomics, so they are deterministic.
template <class T>
__device__ __forceinline__ T block_exclusive_scan(T value, T* buf, T* total) {
    const int t = threadIdx.x, n = blockDim.x;
    buf[t] = value;
    __syncthreads();
    for (int offset = 1; offset < n; offset <<= 1) {
        T add = t >= offset ? buf[t - offset] : 0;
        __syncthreads();
        buf[t] += add;
        __syncthreads();
    }
    T inclusive = buf[t];
    *total = buf[n - 1];
    __syncthreads();
    return inclusive - value;
}

// One block: an exclusive scan over n items, each thread a contiguous run.
// value(i) must not depend on what emit writes for other items; emit(i,
// excl, value) runs after every value of the count pass was read.
template <class V, class E>
__device__ __forceinline__ int runs_scan(long long n, V value, E emit, int* buf) {
    const long long per = (n + blockDim.x - 1) / blockDim.x;
    const long long first = static_cast<long long>(threadIdx.x) * per;
    const long long lo = first < n ? first : n;
    const long long hi = lo + per < n ? lo + per : n;
    int count = 0;
    for (long long i = lo; i < hi; ++i) count += value(i);
    int total;
    int excl = block_exclusive_scan(count, buf, &total);
    for (long long i = lo; i < hi; ++i) {
        const int v = value(i);
        emit(i, excl, v);
        excl += v;
    }
    return total;
}

// Block-wide maximum of one int64 per thread (tree over shared memory;
// blockDim.x a power of two <= 1024). Every thread of the block must call
// it and gets the maximum back.
__device__ __forceinline__ long long block_max(long long value,
                                               long long* buf) {
    const int t = threadIdx.x;
    buf[t] = value;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
        if (t < half && buf[t + half] > buf[t]) buf[t] = buf[t + half];
        __syncthreads();
    }
    const long long out = buf[0];
    __syncthreads();
    return out;
}

// Threads for a one-block launch over `n` items: a power of two in
// [32, 1024].
static inline int block_threads(long long n) {
    int threads = 32;
    while (threads < n && threads < 1024) threads <<= 1;
    return threads;
}

// ---- row copies (K4's row moves, K7's gather and scatter, K12's steals) ---------------

struct alignas(16) Vec16 {
    uint32_t x, y, z, w;
};

// Threads t of nt copy `count` elements of T, each thread loading up to
// four before it stores them, so that a thread keeps several loads in
// flight.
template <class T>
__device__ __forceinline__ void copy_as(uint8_t* dst, const uint8_t* src, long long bytes,
                                        int t, int nt) {
    T* d = reinterpret_cast<T*>(dst);
    const T* s = reinterpret_cast<const T*>(src);
    const long long count = bytes / static_cast<long long>(sizeof(T));
    for (long long j = t; j < count; j += 4LL * nt) {
        T v[4];
        for (int k = 0; k < 4; ++k)
            if (j + k * nt < count) v[k] = s[j + k * nt];
        for (int k = 0; k < 4; ++k)
            if (j + k * nt < count) d[j + k * nt] = v[k];
    }
}

// threads t of nt copy `bytes` with the widest access both ends and the
// length allow
__device__ __forceinline__ void copy_span(uint8_t* dst, const uint8_t* src, long long bytes,
                                          int t, int nt) {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)
                           | static_cast<uintptr_t>(bytes);
    if ((bits & 15) == 0) copy_as<Vec16>(dst, src, bytes, t, nt);
    else if ((bits & 7) == 0) copy_as<unsigned long long>(dst, src, bytes, t, nt);
    else if ((bits & 3) == 0) copy_as<uint32_t>(dst, src, bytes, t, nt);
    else copy_as<uint8_t>(dst, src, bytes, t, nt);
}

// Item `item` of a row copy plan (kernels/ops.py `_copy_plan`): the entries
// [items[item], items[item + 1]) of (leaf, byte offset, bytes), each at most
// 4 KB of one leaf's row. The block copies every entry from src(leaf) +
// offset to dst(leaf) + offset, where src and dst give the row's first byte
// in that leaf. An item of one entry takes the whole block; the entries of
// an item of several (a row's small leaves) go to the block's warps in
// turn, so that they copy side by side.
template <class Dst, class Src>
__device__ __forceinline__ void copy_item(const int* entries, const int* items, int item,
                                          Dst dst, Src src) {
    const int first = items[item], last = items[item + 1];
    const bool split = last - first > 1 && blockDim.x >= 64;
    const int group = split ? 32 : blockDim.x;
    const int groups = blockDim.x / group, g = threadIdx.x / group;
    for (int e = first + g; e < last; e += groups) {
        const int f = entries[3 * e], off = entries[3 * e + 1];
        copy_span(dst(f) + off, src(f) + off, entries[3 * e + 2], threadIdx.x % group, group);
    }
}
