// Host emulation of the CUDA features the port's kernels use, so their
// sources can be compiled by g++ and run on the CPU for rehearsal.
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
struct shim_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local shim_dim3 threadIdx, blockIdx;
inline shim_dim3 blockDim, gridDim;
inline thread_local std::barrier<>* shim_barrier = nullptr;
inline void __syncthreads() { shim_barrier->arrive_and_wait(); }
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
// One std::thread per thread of the block, started once per launch; the
// threads walk the blocks in order, each block with its own barrier (a
// thread that returns leaves it) and a second barrier between blocks, so
// block b+1 starts only when every thread is done with block b.
template <class F, class A>
void shim_launch(F kernel, int grid, int block, const A& args) {
    blockDim.x = block; gridDim.x = grid;
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    for (int b = 0; b < grid; ++b) bars.push_back(std::make_unique<std::barrier<>>(block));
    std::barrier<> between(block);
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
        ts.emplace_back([&, t] {
            threadIdx.x = t;
            for (int b = 0; b < grid; ++b) {
                blockIdx.x = b;
                shim_barrier = bars[b].get();
                kernel(args);
                bars[b]->arrive_and_drop();
                between.arrive_and_wait();
            }
        });
    for (auto& th : ts) th.join();
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
#define MTPU_LAUNCH(kernel, grid, block, stream, args) shim_launch(kernel, grid, block, args)
#define MTPU_LAUNCH_STATUS() 0
