// Host emulation of the CUDA features the traversal kernels use, so that
// g++ can build csrc/*.cu for the CPU and tests can hold the kernels'
// logic against their plain versions without a card
// (tests/test_torch_kernel_emulation.py). Not a CUDA implementation:
//   - one std::thread per CUDA thread, one block at a time;
//   - __syncthreads() and __syncthreads_or() on a std::barrier;
//   - __shared__ is function-static storage, shared by the block's
//     threads because only one block runs at a time;
//   - cp.async (<cuda_pipeline.h>) is a plain copy, made at once; commit
//     and wait are no-ops;
//   - a launch `k<<<grid, block, 0, stream>>>(args)` must be rewritten
//     to `emu_launch(k, grid, block)(args)` before compiling.
// Build with -std=c++20 -ffp-contract=off (as nvcc's -fmad=false).
#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
    unsigned x = 1, y = 1, z = 1;
    dim3(unsigned a = 1) : x(a) {}
};
inline thread_local dim3 threadIdx, blockIdx;
using cudaStream_t = void*;
inline int cudaGetLastError() { return 0; }
inline float __ldg(const float* p) { return *p; }
inline int32_t __ldg(const int32_t* p) { return *p; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline unsigned __float_as_uint(float x) {
    unsigned u;
    std::memcpy(&u, &x, sizeof u);
    return u;
}
inline float __uint_as_float(unsigned u) {
    float x;
    std::memcpy(&x, &u, sizeof x);
    return x;
}
inline int min(int a, int b) { return a < b ? a : b; }

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
    std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

inline std::barrier<>* emu_barrier;
inline std::atomic<int> emu_or{0};

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

inline int __syncthreads_or(int p) {
    emu_barrier->arrive_and_wait();  // every thread has read the last result
    if (p) emu_or.fetch_or(1);
    emu_barrier->arrive_and_wait();
    const int r = emu_or.load();
    emu_barrier->arrive_and_wait();
    if (threadIdx.x == 0) emu_or.store(0);  // before anyone's next OR
    return r;
}

template <class F>
struct EmuLaunch {
    F f;
    dim3 grid;
    unsigned block;
    template <class... A>
    void operator()(A... a) {
        for (unsigned b = 0; b < grid.x; ++b) {
            std::barrier<> bar(block);
            emu_barrier = &bar;
            std::vector<std::thread> threads;
            for (unsigned t = 0; t < block; ++t) {
                threads.emplace_back([&, t, b] {
                    threadIdx = dim3(t);
                    blockIdx = dim3(b);
                    f(a...);
                });
            }
            for (auto& th : threads) th.join();
        }
    }
};

template <class F>
EmuLaunch<F> emu_launch(F f, dim3 grid, unsigned block) {
    return {f, grid, block};
}
