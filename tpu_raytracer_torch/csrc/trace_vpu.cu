// Elementwise worklist sweep of the PyTorch port, for Hopper (sm_90a).
//
//   K5  tpurt_vpu_closest_hit  replaces tpu_raytracer/ops/pallas_trace.py
//       `_mt_kernel` (:1257), the kernel of the trace-kernel mode `vpu`,
//       which the reference feeds with the XLA prepass `_block_entry`
//       (:1326) and its entry sort (:1623-1628); the port builds the same
//       worklists in ops/worklist.py.
//
// Semantics are K1's (trace.cu), exactly: the exact-f32 Moller-Trumbore
// test of mt.cuh, and each lane keeps (t, id) lexicographically, so an
// exact-t tie goes to the lowest triangle id whatever the worklist order.
// The worklists come from padded chunk boxes and hold every chunk K1's
// cull keeps, so K5 returns K1's (t, tri) on every lane.
//
// What bounds it: FP32 throughput, as K1 (~30 FP32 operations, 12 of them
// fused, and one IEEE division per ray-triangle test); the Cornell planes
// (56 KB) stay in L1/L2.
// What the design does about it: little, on purpose. It is the plain
// elementwise form K1 was built from: one thread per ray, each 128-ray
// block walks its own worklist, and every thread reads each triangle
// from global memory through the read-only path (a warp-wide broadcast,
// since all lanes read the same triangle), with no shared-memory staging
// and no per-lane cull. Leaving K1's staging and cull out is what makes
// K5 a measurement of them.

#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

namespace {

using namespace tpurt;

constexpr int CT = 128;         // triangles per chunk
constexpr int BLOCK = 128;      // rays per block: one worklist

__global__ void __launch_bounds__(BLOCK)
vpu_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const float* __restrict__ planes,
           const int32_t* __restrict__ counts,
           const int32_t* __restrict__ chunk_list, int R, int Tp,
           float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
    const int b = blockIdx.x;
    const int r = b * BLOCK + threadIdx.x;
    if (r >= R) return;             // no barrier below: a thread may leave
    const Ray ray = load_ray(o, d, t_min, t_max, r, R);
    float t_best = INF_T;
    int best = -1;
    if (ray.t_max > 0.0f) {         // a dead lane tests nothing
        const int n = __ldg(counts + b);
        for (int i = 0; i < n; ++i) {
            const int c = __ldg(chunk_list + i * gridDim.x + b);
            for (int j = 0; j < CT; ++j) {
                const int g = c * CT + j;
                const auto tri = [planes, g, Tp](int p, int k) {
                    return __ldg(planes + (p * 3 + k) * Tp + g);
                };
                const float t = mt_test(tri, ray, ray.t_max);
                // (t, id) lexicographically: any worklist order gives K1's
                if (t < t_best || (t == t_best && g < best)) {
                    t_best = t;
                    best = g;
                }
            }
        }
    }
    t_out[r] = best >= 0 ? t_best : INF_T;
    tri_out[r] = best;
}

}  // namespace

extern "C" {

// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane); planes [4, 3, Tp] with Tp a multiple of 128; the worklists
// of ceil(R / 128) blocks: counts [nb] and chunk_list [Tp/128, nb] (block
// b sweeps chunk_list[i, b] for i < counts[b]). Outputs t [R] f32 and
// tri [R] i32. Returns cudaGetLastError() after the launch.
int tpurt_vpu_closest_hit(const void* o, const void* d, const void* t_min,
                          const void* t_max, const void* planes,
                          const void* counts, const void* chunk_list, int R,
                          int Tp, void* t_out, void* tri_out, void* stream) {
    if (R > 0) {
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        vpu_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const float*>(planes),
            static_cast<const int32_t*>(counts),
            static_cast<const int32_t*>(chunk_list), R, Tp,
            static_cast<float*>(t_out), static_cast<int32_t*>(tri_out));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
