// The vpu sweep of the PyTorch port, for Hopper (sm_90a).
//
//   K5  tpurt_vpu_closest_hit  replaces tpu_raytracer/ops/pallas_trace.py
//       `_mt_kernel` (:1257), the kernel of the trace-kernel mode `vpu`,
//       and its feeders: the XLA prepass `_block_entry` (:1326) and its
//       entry sort (:1623-1628). The `vpu` route serves both queries with
//       it (any-hit reads tri >= 0).
//
// #8 computes the function K1 computes: the exact-f32 Moller-Trumbore test
// of mt.cuh, and each lane keeps (t, id) lexicographically, so an exact-t
// tie goes to the lowest triangle id. K5 returns K1's (t, tri) on every
// lane, bit for bit.
//
// What bounds it: instruction issue, as K1 (~46 FP32 operations and one
// IEEE division a test, the slab tests that pick the tests, the block's
// fixed cost a step); the tables stay in L2. Its first design walked an
// eager worklist prepass (a slab test of every block and chunk box, then
// a sort: 1.0-1.55 ms a call on the H100, more than the kernel) with one
// thread a ray over every triangle of the block's chunks.
// What the design does about it: K5 is an instance of the front-to-back
// per-lane sweep of sweep.cuh, the design K1/K2 and K3 run: units built
// in the kernel from the padded chunk boxes and sorted by the block's
// entry, each wanted chunk's triangles tested one a thread against just
// the lanes that want the chunk, and the exact exit. No prepass. The unit
// capacity is the caller's: K1's (32) up to MXUF_MAX_TP slots and K3's
// (64) past it (ops/trace_vpu.py:vpu_max_units, by the rule that routes
// K1 and K3).

#include <cuda_runtime.h>

#include <cstdint>

#include "sweep.cuh"

namespace {

using namespace tpurt;

constexpr int BLOCK = SWEEP_BLOCK;

template <int MAX_UNITS>
__global__ void __launch_bounds__(BLOCK)
vpu_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const float* __restrict__ planes, const float* __restrict__ aabb,
           int R, int Tp, int grp, int n_units, float* __restrict__ t_out,
           int32_t* __restrict__ tri_out) {
    sweep<false, MAX_UNITS>(o, d, t_min, t_max, planes, aabb, R, Tp, grp,
                            n_units, t_out, tri_out);
}

}  // namespace

extern "C" {

// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane); planes [4, 3, Tp] with Tp a multiple of 128; aabb
// [Tp/128, 8]; max_units, the unit capacity: 32 or 64. Outputs t [R] f32
// and tri [R] i32. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another capacity.
int tpurt_vpu_closest_hit(const void* o, const void* d, const void* t_min,
                          const void* t_max, const void* planes,
                          const void* aabb, int R, int Tp, int max_units,
                          void* t_out, void* tri_out, void* stream) {
    if (max_units != 32 && max_units != 64) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (R > 0) {
        int grp, n_units;
        sweep_units(Tp / BLOCK, max_units, grp, n_units);
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = max_units == 32 ? vpu_kernel<32> : vpu_kernel<64>;
        kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const float*>(planes), static_cast<const float*>(aabb),
            R, Tp, grp, n_units, static_cast<float*>(t_out),
            static_cast<int32_t*>(tri_out));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
