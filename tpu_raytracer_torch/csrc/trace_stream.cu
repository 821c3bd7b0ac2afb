// Front-to-back streamed traversal kernel of the PyTorch port, for Hopper
// (sm_90a).
//
//   K3  tpurt_stream_closest_hit / tpurt_stream_any_hit  replace
//       tpu_raytracer/ops/pallas_trace.py `_mt_kernel_mxus` (:800), the
//       kernel the reference runs for every flattened scene past 32,768
//       triangle slots, and its feeders: the worklist prepass
//       `_block_entry` (:1326) and the entry sort (:1626-1628).
//
// Semantics are K1's (trace.cu), exactly, and so is the code: both are
// instances of the front-to-back per-lane sweep of sweep.cuh, whose
// comment sets out the design. The TPU kernel breaks exact-t ties in
// worklist order, which the port does not copy: each lane keeps the
// lexicographic minimum of (t, triangle id). Any-hit returns K2's
// contract: tri 1 / -1 and t = t_max.
//
// What differs from K1 is the table: 32,769 slots and more (the knot's
// 100,864 slots are 788 chunks, 4.03 MB of rows read, which stay in the
// 50 MB L2), so a unit holds many chunks: MAX_UNITS 64 makes the knot's
// 50 units of 16 chunks, each swept in segments of up to 32 chunks.

#include <cuda_runtime.h>

#include <cstdint>

#include "sweep.cuh"

namespace {

using namespace tpurt;

constexpr int BLOCK = SWEEP_BLOCK;
// unit capacity; a smaller build-time value makes units of more chunks
// (the g++ emulation's tests build 16 and 8)
#ifndef TPURT_MAX_UNITS
#define TPURT_MAX_UNITS 64
#endif
constexpr int MAX_UNITS = TPURT_MAX_UNITS;

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
stream_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_min,
              const float* __restrict__ t_max,
              const float* __restrict__ planes,
              const float* __restrict__ aabb, int R, int Tp, int grp,
              int n_units, float* __restrict__ t_out,
              int32_t* __restrict__ tri_out) {
    sweep<ANY, MAX_UNITS>(o, d, t_min, t_max, planes, aabb, R, Tp, grp,
                          n_units, t_out, tri_out);
}

int launch(bool any_hit, const void* o, const void* d, const void* t_min,
           const void* t_max, const void* planes, const void* aabb, int R,
           int Tp, void* t_out, void* tri_out, void* stream) {
    if (R > 0) {
        int grp, n_units;
        sweep_units(Tp / BLOCK, MAX_UNITS, grp, n_units);
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = any_hit ? stream_kernel<true> : stream_kernel<false>;
        kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const float*>(planes), static_cast<const float*>(aabb),
            R, Tp, grp, n_units, static_cast<float*>(t_out),
            static_cast<int32_t*>(tri_out));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane); planes [4, 3, Tp] with Tp a multiple of 128; aabb
// [Tp/128, 8]. Outputs t [R] f32 and tri [R] i32. Returns
// cudaGetLastError() after the launch.
int tpurt_stream_closest_hit(const void* o, const void* d,
                             const void* t_min, const void* t_max,
                             const void* planes, const void* aabb, int R,
                             int Tp, void* t_out, void* tri_out,
                             void* stream) {
    return launch(false, o, d, t_min, t_max, planes, aabb, R, Tp, t_out,
                  tri_out, stream);
}

int tpurt_stream_any_hit(const void* o, const void* d, const void* t_min,
                         const void* t_max, const void* planes,
                         const void* aabb, int R, int Tp, void* t_out,
                         void* tri_out, void* stream) {
    return launch(true, o, d, t_min, t_max, planes, aabb, R, Tp, t_out,
                  tri_out, stream);
}

}  // extern "C"
