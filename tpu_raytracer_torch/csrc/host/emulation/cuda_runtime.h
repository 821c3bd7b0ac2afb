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
//   - __syncwarp() on one std::barrier per warp; the warp votes and
//     reductions (__ballot_sync, __reduce_min_sync, __reduce_or_sync)
//     exchange the lanes' values through a static buffer between warp
//     barriers, so every thread of a warp must call them the same number
//     of times (warps may differ); __syncthreads_count counts on an
//     atomic as __syncthreads_or does;
//   - atomicMin, atomicOr, atomicExch and atomicAdd are std::atomic_ref
//     operations;
//   - the warp-level bf16 product of csrc/mma.cuh (mma_split) exchanges
//     the fragments through a static buffer between two warp barriers and
//     sums each output's exact products in f64, rounding once to f32;
//     every thread of a warp must call it the same number of times;
//   - the global nanosecond timer (%globaltimer, csrc/marks.cu) is the
//     host's steady clock, `emu_globaltimer`;
//   - a launch `k<<<grid, block, 0, stream>>>(args)` must be rewritten
//     to `emu_launch(k, grid, block)(args)` before compiling;
//   - with -DTPURT_EMU_ROUNDED_LIBM, sinf, cosf, expf and powf are the
//     double functions rounded to f32 (correctly rounded but for the rarest
//     arguments), so that a test can hold a kernel's f32 arithmetic to a
//     plain version computed with the same rounded functions, bit for bit.
// Build with -std=c++20 -ffp-contract=off (as nvcc's -fmad=false).
#pragma once

#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>

#define TPURT_HOST_EMULATION 1
#ifdef TPURT_EMU_ROUNDED_LIBM
#define sinf(x) static_cast<float>(std::sin(static_cast<double>(x)))
#define cosf(x) static_cast<float>(std::cos(static_cast<double>(x)))
#define expf(x) static_cast<float>(std::exp(static_cast<double>(x)))
#define powf(x, y) \
    static_cast<float>(std::pow(static_cast<double>(x), static_cast<double>(y)))
#endif
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
inline thread_local dim3 threadIdx, blockIdx, gridDim;
using cudaStream_t = void*;
constexpr int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
inline float __ldg(const float* p) { return *p; }
inline int32_t __ldg(const int32_t* p) { return *p; }
inline uint32_t __ldg(const uint32_t* p) { return *p; }
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
inline int64_t emu_globaltimer() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }

struct alignas(16) float4 {
    float x, y, z, w;
};
inline float4 __ldg(const float4* p) { return *p; }
inline float4 make_float4(float x, float y, float z, float w) {
    return {x, y, z, w};
}
struct alignas(16) uint4 {
    unsigned x, y, z, w;
};

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
    std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

template <class T>
inline T atomicMin(T* p, T v) {
    std::atomic_ref<T> a(*p);
    T old = a.load();
    while (v < old && !a.compare_exchange_weak(old, v)) {
    }
    return old;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
    return std::atomic_ref<unsigned>(*p).fetch_or(v);
}
inline int atomicExch(int* p, int v) {
    return std::atomic_ref<int>(*p).exchange(v);
}
inline int atomicAdd(int* p, int v) {
    return std::atomic_ref<int>(*p).fetch_add(v);
}

inline std::barrier<>* emu_barrier;
inline std::deque<std::barrier<>>* emu_warp_barriers;   // one a warp
inline std::atomic<int> emu_or{0};

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
    (*emu_warp_barriers)[threadIdx.x / 32].arrive_and_wait();
}

inline int __syncthreads_or(int p) {
    emu_barrier->arrive_and_wait();  // every thread has read the last result
    if (p) emu_or.fetch_or(1);
    emu_barrier->arrive_and_wait();
    const int r = emu_or.load();
    emu_barrier->arrive_and_wait();
    if (threadIdx.x == 0) emu_or.store(0);  // before anyone's next OR
    return r;
}

inline int __syncthreads_count(int p) {
    emu_barrier->arrive_and_wait();
    if (p) emu_or.fetch_add(1);
    emu_barrier->arrive_and_wait();
    const int r = emu_or.load();
    emu_barrier->arrive_and_wait();
    if (threadIdx.x == 0) emu_or.store(0);
    return r;
}

// The warp's 32 values of `v` in lane order, folded by f from `init`.
template <class F>
inline unsigned emu_warp_fold(unsigned v, unsigned init, F f) {
    static unsigned lanes[1024];
    __syncwarp();                    // the last call's reads are done
    lanes[threadIdx.x] = v;
    __syncwarp();
    const unsigned base = threadIdx.x / 32 * 32;
    unsigned acc = init;
    for (unsigned l = 0; l < 32; ++l) acc = f(acc, l, lanes[base + l]);
    return acc;
}
inline unsigned __ballot_sync(unsigned, int p) {
    return emu_warp_fold(p != 0, 0u, [](unsigned a, unsigned l, unsigned x) {
        return a | (x << l);
    });
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
    return emu_warp_fold(v, 0u, [](unsigned a, unsigned, unsigned x) {
        return a | x;
    });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
    return emu_warp_fold(v, ~0u, [](unsigned a, unsigned, unsigned x) {
        return x < a ? x : a;
    });
}

// mma_split (csrc/mma.cuh): c[m][n] = A_m . B_n over K = 16 for a warp's
// mt row tiles of 16 and nq column tiles of 8, from bf16 hi/lo fragments in
// the PTX ISA's m16n8k16 layout; passes 3 sums hi*hi + hi*lo + lo*hi.
constexpr int EMU_MAX_MT = 4, EMU_MAX_NQ = 4;
struct EmuFrags {
    uint32_t a[2][EMU_MAX_MT][4];      // [hi | lo][m][register]
    uint32_t b[2][EMU_MAX_NQ][2];
};

inline float emu_bf16(uint32_t word, int half) {
    const unsigned bits = (word >> (16 * half)) & 0xffffu;
    return __uint_as_float(bits << 16);
}

inline void emu_mma_split(int passes, int mt, int nq, float* c,
                          const uint32_t* a_hi, const uint32_t* a_lo,
                          const uint32_t* b_hi, const uint32_t* b_lo) {
    static EmuFrags frags[1024];
    const unsigned tid = threadIdx.x;
    __syncwarp();                    // the last call's reads are done
    EmuFrags& mine = frags[tid];
    std::memcpy(mine.a[0], a_hi, sizeof(uint32_t) * 4 * mt);
    std::memcpy(mine.a[1], a_lo, sizeof(uint32_t) * 4 * mt);
    std::memcpy(mine.b[0], b_hi, sizeof(uint32_t) * 2 * nq);
    std::memcpy(mine.b[1], b_lo, sizeof(uint32_t) * 2 * nq);
    __syncwarp();
    const unsigned warp = tid / 32 * 32, g = tid % 32 / 4, q = tid % 4;
    // A[row][k] of row tile m, operand half s (0 hi, 1 lo)
    auto a_at = [&](int s, int m, int row, int k) {
        const EmuFrags& f = frags[warp + (row % 8) * 4 + (k % 8) / 2];
        return emu_bf16(f.a[s][m][row / 8 + 2 * (k / 8)], k % 2);
    };
    // B[k][col] of column tile n
    auto b_at = [&](int s, int n, int k, int col) {
        const EmuFrags& f = frags[warp + col * 4 + (k % 8) / 2];
        return emu_bf16(f.b[s][n][k / 8], k % 2);
    };
    for (int m = 0; m < mt; ++m) {
        for (int n = 0; n < nq; ++n) {
            for (int e = 0; e < 4; ++e) {
                const int row = g + 8 * (e / 2), col = 2 * q + e % 2;
                double s = 0.0;
                for (int k = 0; k < 16; ++k) {
                    const double ah = a_at(0, m, row, k);
                    const double bh = b_at(0, n, k, col);
                    s += ah * bh;
                    if (passes == 3) {
                        s += ah * double(b_at(1, n, k, col));
                        s += double(a_at(1, m, row, k)) * bh;
                    }
                }
                c[(m * nq + n) * 4 + e] = static_cast<float>(s);
            }
        }
    }
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
            std::deque<std::barrier<>> warps;
            for (unsigned w = 0; w < block / 32; ++w) warps.emplace_back(32);
            emu_warp_barriers = &warps;
            std::vector<std::thread> threads;
            for (unsigned t = 0; t < block; ++t) {
                threads.emplace_back([&, t, b] {
                    threadIdx = dim3(t);
                    blockIdx = dim3(b);
                    gridDim = grid;
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
