// Triangle traversal kernels of the PyTorch port, for Hopper (sm_90a).
//
//   K1  tpurt_closest_hit  replaces tpu_raytracer/ops/pallas_trace.py
//       `_mt_kernel_mxuf` (:392) and `_mt_kernel_mxuv` (:492), and the XLA
//       prepass `_block_entry` (:1326) that fed them chunk worklists.
//   K2  tpurt_any_hit      replaces `_mt_kernel_any` (:611).
//
// Both take the semantics of the exact-f32 scan
// `tpu_raytracer/ops/trace_api.py:_trace_brute_xla`, not the bf16 window
// numerics of the TPU kernels: Moller-Trumbore with |det| > 1e-9,
// u >= 0, v >= 0, u + v <= 1 and t_min < t < t_max, and an exact-t tie
// goes to the lowest triangle id. The arithmetic is the plain version's
// (ops/trace_api.py:trace_plain), operation for operation (mt.cuh), so K1
// returns the plain version's (t, tri) bit for bit, including the exact-t
// ties where two triangles meet at an edge. K2 returns tri 1 / -1 and
// t = t_max, the TPU any-hit kernel's contract.
//
// What bounds them: instruction issue, not bytes. The tables on this route
// hold at most MXUF_MAX_TP = 32,768 slots (256 chunks; the Cornell box 11,
// the bunny 121, the restir scene 251), whose rows stay in L1/L2. A
// random ray needs the exact tests (~46 FP32 operations and one IEEE
// division each) of the chunks its final window passes, about 106 on the
// Cornell box; a sweep with one thread a ray over the chunks in id order
// ran every lane through the union of its warp's chunks, narrowed the
// window in id order rather than front to back, and paid three block
// barriers a chunk.
// What the design does about it: both are instances of the front-to-back
// per-lane sweep of sweep.cuh, which K3 (trace_stream.cu) also runs: per
// 128-ray block, the chunks grouped into at most MAX_UNITS units, sorted
// by the block's entry, swept front to back in segments with two barriers
// each, and each wanted chunk's triangles tested one a thread against
// just the lanes that want the chunk. Closest-hit leaves before the first
// unit that no live lane can still improve on; any-hit once every live
// lane is occluded. MAX_UNITS 32: the Cornell box sweeps chunk by chunk
// (11 units), the bunny in 31 units of 4 chunks, the restir scene in 32
// of 8. On the H100 (PERF.md §6, PR 8) 16 units were 5-7% faster on
// random bunny and restir rays and 2-8% slower on their primary rays; 64
// units 10% faster on primary bunny closest-hit and 15-19% slower on
// random rays, 128 units 39-60% slower on random rays; whole-table
// staging of the Cornell box's 56 KB in shared memory was 1.6-2.0x
// slower than loads from L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "sweep.cuh"

namespace {

using namespace tpurt;

constexpr int BLOCK = SWEEP_BLOCK;
// unit capacity (ops/trace_api.py:SWEPT_MAX_UNITS); the g++ emulation's
// tests also build 8
#ifndef TPURT_SWEPT_MAX_UNITS
#define TPURT_SWEPT_MAX_UNITS 32
#endif
constexpr int MAX_UNITS = TPURT_SWEPT_MAX_UNITS;

#define TRACE_ARGS                                                       \
    const float* __restrict__ o, const float* __restrict__ d,            \
        const float* __restrict__ t_min, const float* __restrict__ t_max, \
        const float* __restrict__ planes, const float* __restrict__ aabb, \
        int R, int Tp, int grp, int n_units, float* __restrict__ t_out,  \
        int32_t* __restrict__ tri_out
#define TRACE_PASS \
    o, d, t_min, t_max, planes, aabb, R, Tp, grp, n_units, t_out, tri_out

__global__ void __launch_bounds__(BLOCK) closest_hit_kernel(TRACE_ARGS) {
    sweep<false, MAX_UNITS>(TRACE_PASS);
}

__global__ void __launch_bounds__(BLOCK) any_hit_kernel(TRACE_ARGS) {
    sweep<true, MAX_UNITS>(TRACE_PASS);
}

int launch(bool any_hit, const void* o, const void* d, const void* t_min,
           const void* t_max, const void* planes, const void* aabb, int R,
           int Tp, void* t_out, void* tri_out, void* stream) {
    if (R > 0) {
        int grp, n_units;
        sweep_units(Tp / BLOCK, MAX_UNITS, grp, n_units);
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = any_hit ? any_hit_kernel : closest_hit_kernel;
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
int tpurt_closest_hit(const void* o, const void* d, const void* t_min,
                      const void* t_max, const void* planes,
                      const void* aabb, int R, int Tp, void* t_out,
                      void* tri_out, void* stream) {
    return launch(false, o, d, t_min, t_max, planes, aabb, R, Tp, t_out,
                  tri_out, stream);
}

int tpurt_any_hit(const void* o, const void* d, const void* t_min,
                  const void* t_max, const void* planes, const void* aabb,
                  int R, int Tp, void* t_out, void* tri_out, void* stream) {
    return launch(true, o, d, t_min, t_max, planes, aabb, R, Tp, t_out,
                  tri_out, stream);
}

}  // extern "C"
