// Host emulation of the CUDA features the port's kernels use, so their
// sources can be compiled by g++ and run on the CPU for rehearsal.
//
// A launch runs on the calling thread: each CUDA thread of the block is a
// fiber (ucontext) with its own stack, and the fibers walk the blocks in
// order. `__syncthreads` yields; a round resumes every fiber still in the
// block once, so each runs to its next barrier and a barrier opens when
// every fiber that has not returned reached it. A fiber done with a block
// waits until all are, then every fiber starts the next block.
#pragma once
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <ucontext.h>
#include <vector>
struct shim_dim3 { unsigned x = 0, y = 0, z = 0; };
inline shim_dim3 threadIdx, blockIdx, blockDim, gridDim;
namespace shim {
enum { STACK_BYTES = 1 << 18 };
struct Fiber {
    ucontext_t ctx;
    std::unique_ptr<char[]> stack;  // uninitialized: pages commit on use
    bool done = true, between = false;
};
inline ucontext_t scheduler;
inline std::vector<Fiber> fibers;
inline int current = 0;
inline void (*body)(void*) = nullptr;
inline void* body_arg = nullptr;
inline void yield() { swapcontext(&fibers[current].ctx, &scheduler); }
// one fiber: the kernel for each block, then wait for the others
inline void run_fiber() {
    for (unsigned b = 0; b < gridDim.x; ++b) {
        blockIdx.x = b;
        body(body_arg);
        fibers[current].between = true;
        yield();
    }
    fibers[current].done = true;
}
}  // namespace shim
inline void __syncthreads() { shim::yield(); }
#define __global__
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
    for (;;) {
        bool live = false, running = false;
        for (int t = 0; t < block; ++t) {
            live = live || !fibers[t].done;
            running = running || (!fibers[t].done && !fibers[t].between);
        }
        if (!live) break;
        if (!running)  // every fiber is done with the block: the next one
            for (int t = 0; t < block; ++t) fibers[t].between = false;
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
inline int __ffs(int x) { return __builtin_ffs(x); }
#define MTPU_LAUNCH(kernel, grid, block, stream, args) shim_launch(kernel, grid, block, args)
#define MTPU_LAUNCH_STATUS() 0
#define MTPU_PRELOAD(kernel) 0
