// Host emulation of the CUDA features the port's kernels use, so their
// sources can be compiled by g++ and run on the CPU for rehearsal.
//
// A launch runs on the calling thread: each CUDA thread of the block is a
// fiber (ucontext) with its own stack, and the fibers walk the blocks in
// order (blocks never overlap, so a fixture must spread its work over
// several blocks for a cross-block hand-off to run at all). A round
// resumes every fiber still in the block once. `__syncthreads` is a
// counting barrier over the fibers still in the block: a fiber waits,
// yielding, until every one that has not returned arrived. The warp
// intrinsics (`__shfl*_sync`, `__ballot_sync`, `__syncwarp`) are the same
// barrier over the fiber's warp of 32: a shuffle stores its value, waits
// for the warp, reads its source lane and waits again, so every fiber of
// the warp must reach it (the full mask, as the kernels use it). A fiber
// done with a block waits until all are, then every fiber starts the next
// block.
#pragma once
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <ucontext.h>
#include <vector>
struct shim_dim3 { unsigned x = 0, y = 0, z = 0; };
inline shim_dim3 threadIdx, blockIdx, blockDim, gridDim;
namespace shim {
enum { STACK_BYTES = 1 << 18, WARP = 32 };
struct Fiber {
    ucontext_t ctx;
    std::unique_ptr<char[]> stack;  // uninitialized: pages commit on use
    bool done = true, between = false;
};
// a counting barrier: arrivals in this generation, the fibers still in
// the block (or warp) that it waits for
struct Barrier {
    int arrived = 0, live = 0;
    unsigned generation = 0;
};
inline ucontext_t scheduler;
inline std::vector<Fiber> fibers;
inline Barrier block_barrier;
inline std::vector<Barrier> warp_barriers;
inline std::vector<unsigned long long> lane_values;  // a shuffle's stores
inline int current = 0;
inline void (*body)(void*) = nullptr;
inline void* body_arg = nullptr;
inline void yield() { swapcontext(&fibers[current].ctx, &scheduler); }
inline void open(Barrier& bar) {
    bar.arrived = 0;
    ++bar.generation;
}
inline void wait(Barrier& bar) {
    const unsigned generation = bar.generation;
    if (++bar.arrived >= bar.live) {
        open(bar);
        return;
    }
    while (bar.generation == generation) yield();
}
inline void leave(Barrier& bar) {
    --bar.live;
    if (bar.arrived && bar.arrived >= bar.live) open(bar);
}
// every barrier of a block about to start, for `block` threads
inline void reset_barriers(int block) {
    block_barrier.live = block;
    block_barrier.arrived = 0;
    warp_barriers.resize((block + WARP - 1) / WARP);
    for (int w = 0; w < static_cast<int>(warp_barriers.size()); ++w) {
        warp_barriers[w].live = block - w * WARP < WARP ? block - w * WARP : WARP;
        warp_barriers[w].arrived = 0;
    }
    lane_values.assign(block, 0);
}
inline Barrier& my_warp() { return warp_barriers[threadIdx.x / WARP]; }
// one fiber: the kernel for each block, then wait for the others
inline void run_fiber() {
    for (unsigned b = 0; b < gridDim.x; ++b) {
        blockIdx.x = b;
        body(body_arg);
        leave(block_barrier);
        leave(my_warp());
        fibers[current].between = true;
        yield();
    }
    fibers[current].done = true;
}
// the value lane `src` of the caller's warp passed, every lane of the warp
// passing its own (`src` < 0: the caller's own value comes back)
template <class T>
inline T exchange(T value, int src) {
    static_assert(sizeof(T) <= sizeof(unsigned long long), "shuffle of a wide type");
    const unsigned t = threadIdx.x;
    unsigned long long bits = 0;
    std::memcpy(&bits, &value, sizeof(T));
    lane_values[t] = bits;
    wait(my_warp());
    const unsigned from = src < 0 ? t : (t & ~(WARP - 1u)) + static_cast<unsigned>(src);
    T out = value;
    if (from < blockDim.x) std::memcpy(&out, &lane_values[from], sizeof(T));
    wait(my_warp());
    return out;
}
}  // namespace shim
inline void __syncthreads() { shim::wait(shim::block_barrier); }
inline void __syncwarp(unsigned = 0xffffffffu) { shim::wait(shim::my_warp()); }
template <class T>
inline T __shfl_sync(unsigned, T value, int src, int width = shim::WARP) {
    const int lane = threadIdx.x % shim::WARP;
    return shim::exchange(value, (lane & ~(width - 1)) + src % width);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T value, int mask, int width = shim::WARP) {
    const int lane = threadIdx.x % shim::WARP, src = lane ^ mask;
    return shim::exchange(value, (src & ~(width - 1)) == (lane & ~(width - 1)) ? src : -1);
}
template <class T>
inline T __shfl_down_sync(unsigned, T value, unsigned delta, int width = shim::WARP) {
    const int lane = threadIdx.x % shim::WARP, src = lane + static_cast<int>(delta);
    return shim::exchange(value, (src & ~(width - 1)) == (lane & ~(width - 1)) ? src : -1);
}
// bit i: lane i of the caller's warp passed a true predicate (a lane that
// has returned reads 0)
inline unsigned __ballot_sync(unsigned, int predicate) {
    const unsigned t = threadIdx.x, first = t & ~(shim::WARP - 1u);
    shim::lane_values[t] = predicate != 0;
    shim::wait(shim::my_warp());
    unsigned votes = 0;
    for (unsigned lane = 0; lane < shim::WARP && first + lane < blockDim.x; ++lane)
        if (!shim::fibers[first + lane].between && shim::lane_values[first + lane])
            votes |= 1u << lane;
    shim::wait(shim::my_warp());
    return votes;
}
#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
template <class F, class A>
void shim_launch(F kernel, int grid, int block, const A& args) {
    using shim::fibers;
    blockDim.x = block;
    gridDim.x = grid;
    struct Call {
        F kernel;
        const A* args;
        static void run(void* self) {
            Call* call = static_cast<Call*>(self);
            call->kernel(*call->args);
        }
    } call = {kernel, &args};
    shim::body = &Call::run;
    shim::body_arg = &call;
    if (static_cast<int>(fibers.size()) < block) fibers.resize(block);
    for (int t = 0; t < block; ++t) {
        shim::Fiber& f = fibers[t];
        if (!f.stack) f.stack.reset(new char[shim::STACK_BYTES]);
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = f.stack.get();
        f.ctx.uc_stack.ss_size = shim::STACK_BYTES;
        f.ctx.uc_link = &shim::scheduler;
        makecontext(&f.ctx, shim::run_fiber, 0);
        f.done = f.between = false;
    }
    shim::reset_barriers(block);
    for (;;) {
        bool live = false, running = false;
        for (int t = 0; t < block; ++t) {
            live = live || !fibers[t].done;
            running = running || (!fibers[t].done && !fibers[t].between);
        }
        if (!live) break;
        if (!running) {  // every fiber is done with the block: the next one
            for (int t = 0; t < block; ++t) fibers[t].between = false;
            shim::reset_barriers(block);
        }
        for (int t = 0; t < block; ++t) {
            if (fibers[t].done || fibers[t].between) continue;
            shim::current = t;
            threadIdx.x = t;
            swapcontext(&shim::scheduler, &fibers[t].ctx);
        }
    }
}
template <class T>
inline T atomicAdd(T* address, T value) {
    return std::atomic_ref<T>(*address).fetch_add(value);
}
template <class T>
inline T atomicMax(T* address, T value) {
    std::atomic_ref<T> ref(*address);
    T old = ref.load();
    while (old < value && !ref.compare_exchange_weak(old, value)) {
    }
    return old;
}
template <class T>
inline T atomicMin(T* address, T value) {
    std::atomic_ref<T> ref(*address);
    T old = ref.load();
    while (value < old && !ref.compare_exchange_weak(old, value)) {
    }
    return old;
}
template <class T>
inline T atomicOr(T* address, T value) {
    return std::atomic_ref<T>(*address).fetch_or(value);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// host memory is its own device address here
inline int cudaHostGetDevicePointer(void** device, void* host, unsigned) {
    *device = host;
    return 0;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
#define MTPU_LAUNCH(kernel, grid, block, stream, args) shim_launch(kernel, grid, block, args)
#define MTPU_LAUNCH_STATUS() 0
#define MTPU_PRELOAD(kernel) 0
