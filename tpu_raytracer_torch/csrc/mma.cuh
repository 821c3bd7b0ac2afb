// The tensor-core product of K6 (trace_mxu.cu): bf16 operands split into
// hi and lo halves, f32 accumulation, on the warp-level
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX ISA, sm_80 and
// later; sm_90a runs it).
//
// Fragments follow the PTX ISA's layout for m16n8k16, with g = lane / 4
// and q = lane % 4, each 32-bit word two bf16 values, the lower index in
// the lower half:
//   A (16 x 16, row-major)  a[0] = A[g][2q..2q+1]      a[1] = A[g+8][2q..]
//                           a[2] = A[g][2q+8..2q+9]    a[3] = A[g+8][2q+8..]
//   B (16 x 8, column n)    b[0] = B[2q..2q+1][g]      b[1] = B[2q+8..][g]
//   C (16 x 8, f32)         c[0..1] = C[g][2q..2q+1]   c[2..3] = C[g+8][2q..]
//
// Under the host emulation (csrc/host/emulation/cuda_runtime.h) the same
// function exchanges the fragments between the threads of the warp and sums
// the exact products in f64, rounding once; every thread of the warp must
// call it the same number of times (warps may differ).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tpurt {

// f32 -> bf16 bits, rounded to nearest even (x finite).
__device__ __forceinline__ uint32_t bf16_bits(float x) {
    const uint32_t u = __float_as_uint(x);
    return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float bf16_value(uint32_t bits) {
    return __uint_as_float(bits << 16);
}

// (hi, lo) bf16 bits of x, hi + lo ~ x to 16 significant bits (the
// reference's _split_bf16; x - hi is exact in f32).
__device__ __forceinline__ void split_bf16(float x, uint32_t& hi,
                                           uint32_t& lo) {
    hi = bf16_bits(x);
    lo = bf16_bits(x - bf16_value(hi));
}

#ifndef TPURT_HOST_EMULATION
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// One warp's product tile: c[m][n] = A_m . B_n for MT row tiles of 16 and
// NQ column tiles of 8, K = 16, from split operands. PASSES = 3 sums
// hi*hi + hi*lo + lo*hi into one f32 accumulator (the reference's fused
// K = 48 dot, in its order); PASSES = 1 takes hi*hi alone.
template <int PASSES, int MT, int NQ>
__device__ __forceinline__ void mma_split(float (&c)[MT][NQ][4],
                                          const uint32_t (&a_hi)[MT][4],
                                          const uint32_t (&a_lo)[MT][4],
                                          const uint32_t (&b_hi)[NQ][2],
                                          const uint32_t (&b_lo)[NQ][2]) {
    static_assert(PASSES == 1 || PASSES == 3, "1 or 3 passes");
#ifdef TPURT_HOST_EMULATION
    emu_mma_split(PASSES, MT, NQ, &c[0][0][0], &a_hi[0][0], &a_lo[0][0],
                  &b_hi[0][0], &b_lo[0][0]);
#else
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
            c[m][n][0] = c[m][n][1] = c[m][n][2] = c[m][n][3] = 0.0f;
            mma_m16n8k16(c[m][n], a_hi[m], b_hi[n]);
            if (PASSES == 3) {
                mma_m16n8k16(c[m][n], a_hi[m], b_lo[n]);
                mma_m16n8k16(c[m][n], a_lo[m], b_hi[n]);
            }
        }
    }
#endif
}

}  // namespace tpurt
