// Host emulation of the CUDA features the port's kernels use, so their
// sources can be compiled by g++ and run on the CPU for rehearsal.
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>
struct shim_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local shim_dim3 threadIdx, blockIdx;
inline shim_dim3 blockDim, gridDim;
inline std::barrier<>* shim_barrier = nullptr;
inline void __syncthreads() { shim_barrier->arrive_and_wait(); }
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
template <class F, class A>
void shim_launch(F kernel, int grid, int block, const A& args) {
    blockDim.x = block; gridDim.x = grid;
    for (int b = 0; b < grid; ++b) {
        std::barrier<> bar(block);
        shim_barrier = &bar;
        std::vector<std::thread> ts;
        for (int t = 0; t < block; ++t)
            ts.emplace_back([&, t, b] {
                threadIdx.x = t; blockIdx.x = b;
                kernel(args);
                bar.arrive_and_drop();
            });
        for (auto& th : ts) th.join();
    }
}
template <class T>
inline T atomicAdd(T* address, T value) {
    return std::atomic_ref<T>(*address).fetch_add(value);
}
#define MTPU_LAUNCH(kernel, grid, block, stream, args) shim_launch(kernel, grid, block, args)
#define MTPU_LAUNCH_STATUS() 0
