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
// u >= 0, v >= 0, u + v <= 1 and t_min < t < t_max; closest-hit keeps a
// strict `t < t_best`, so an exact-t tie goes to the lowest triangle id.
// The arithmetic is the plain version's (ops/trace_api.py:trace_plain),
// operation for operation (mt.cuh), so K1 returns the plain version's
// (t, tri) bit for bit, including the exact-t ties where two triangles
// meet at an edge.
//
// What bounds them: FP32 issue rate, not bytes. A Cornell scene is 1,408
// triangle slots (56 KB of planes) that stay in L1/L2; every ray tests
// every triangle of every chunk its block does not cull: ~30 FP32
// operations (12 of them fused) and one IEEE division per test.
// What the design does about it: one thread per ray, one 128-ray block
// per 128-triangle chunk step. A block first slab-tests the chunk's AABB
// for each live lane against its window (t_min, min(t_max, t_best)) and
// skips the chunk unless some lane passes (__syncthreads_or), so coherent
// blocks (primary rays, shadow rays with short windows) test few chunks;
// a chunk that survives is staged once into 5 KB of shared memory and
// read as broadcasts, so the inner loop issues arithmetic, not loads.
// Any-hit lanes stop at their first hit, and the block leaves the sweep
// once every live lane is occluded. Front-to-back chunk order, tensor
// cores and TMA are left to later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

namespace {

using namespace tpurt;

constexpr int CT = 128;         // triangles per chunk (cull granularity)
constexpr int BLOCK = CT;       // rays per block
using Chunk = Tris<CT>;

__global__ void __launch_bounds__(BLOCK)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_min,
                   const float* __restrict__ t_max,
                   const float* __restrict__ planes,
                   const float* __restrict__ aabb, int R, int Tp,
                   float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
    __shared__ Chunk sh;
    const int r = blockIdx.x * BLOCK + threadIdx.x;
    Ray ray = {};
    if (r < R) ray = load_ray(o, d, t_min, t_max, r, R);
    const bool live = r < R && ray.t_max > 0.0f;
    float t_best = INF_T;
    int best = -1;
    const int nc = Tp / CT;
    for (int c = 0; c < nc; ++c) {
        // t_hi = min(t_max, t_best): the running best tightens the window
        const float t_hi = fminf(ray.t_max, t_best);
        const bool want =
            live && slab_pass(aabb + c * 8, 1, ray, ray.t_min, t_hi);
        if (!__syncthreads_or(want)) continue;
        stage<CT, BLOCK>(sh, planes, c * CT, Tp);
        __syncthreads();
        if (want) {
            for (int i = 0; i < CT; ++i) {
                // strict `<` against the running best: ties keep the
                // lowest id, as the plain chunked argmin does
                const float t = intersect(sh, i, ray,
                                          fminf(ray.t_max, t_best));
                if (t < t_best) {
                    t_best = t;
                    best = c * CT + i;
                }
            }
        }
        __syncthreads();
    }
    if (r < R) {
        t_out[r] = best >= 0 ? t_best : INF_T;
        tri_out[r] = best;
    }
}

__global__ void __launch_bounds__(BLOCK)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_min,
               const float* __restrict__ t_max,
               const float* __restrict__ planes,
               const float* __restrict__ aabb, int R, int Tp,
               float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
    __shared__ Chunk sh;
    const int r = blockIdx.x * BLOCK + threadIdx.x;
    Ray ray = {};
    if (r < R) ray = load_ray(o, d, t_min, t_max, r, R);
    const bool live = r < R && ray.t_max > 0.0f;
    bool hit = false;
    const int nc = Tp / CT;
    for (int c = 0; c < nc; ++c) {
        // leave once every live lane is occluded
        if (!__syncthreads_or(live && !hit)) break;
        const bool want = live && !hit &&
                          slab_pass(aabb + c * 8, 1, ray, ray.t_min,
                                    ray.t_max);
        if (!__syncthreads_or(want)) continue;
        stage<CT, BLOCK>(sh, planes, c * CT, Tp);
        __syncthreads();
        if (want) {
            for (int i = 0; i < CT && !hit; ++i) {
                hit = intersect(sh, i, ray, ray.t_max) < INF_T;
            }
        }
        __syncthreads();
    }
    if (r < R) {
        // the TPU kernel's contract: idx 1 or -1, t = t_max
        t_out[r] = ray.t_max;
        tri_out[r] = hit ? 1 : -1;
    }
}

int launch(bool any_hit, const void* o, const void* d, const void* t_min,
           const void* t_max, const void* planes, const void* aabb, int R,
           int Tp, void* t_out, void* tri_out, void* stream) {
    if (R > 0) {
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = any_hit ? any_hit_kernel : closest_hit_kernel;
        kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const float*>(planes), static_cast<const float*>(aabb),
            R, Tp, static_cast<float*>(t_out), static_cast<int32_t*>(tri_out));
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
