// Two-level instanced traversal kernel of the PyTorch port, for Hopper
// (sm_90a).
//
//   K4  tpurt_inst_closest_hit / tpurt_inst_any_hit  replace
//       tpu_raytracer/ops/pallas_trace.py `_mt_kernel_inst` (:1916) and
//       the block x instance bitmask prepass of its caller
//       `trace_instanced_pallas` (:2133-2158).
//
// Semantics are those of the reference's exact-f32 CPU scan
// `_trace_instanced_xla` (:2202), not the bf16 window of the TPU kernel:
// each instance's world->object affine (inst_table cols 0:12, A^-1 | b)
// moves the ray into object space with an unnormalized direction, so t
// is the same in both spaces; the object-space triangles, shared by every
// instance of a mesh, are tested with the Moller-Trumbore test of mt.cuh.
// The transform is rounded as XLA:CPU rounds the reference's
// `ray_o @ a.T + b`: fma(a[r,2], z, fma(a[r,1], y, a[r,0] * x)) + b[r],
// the direction without `+ b` (ops/trace_inst.py:to_object does the
// same). Closest-hit keeps a strict `t < t_best` while it walks
// instances in order, then each instance's groups in order, then the
// group's triangles in lane order: an exact-t tie goes to the earlier
// instance, group and lane, the reference's unit scan order. The result
// is (t, object triangle g * 256 + lane, instance), or (INF, -1, -1).
//
// What bounds it: FP32 issue rate, not bytes. The gallery's object
// planes are 215 KB (5,376 slots) and stay in L2; every ray tests every
// triangle of every group its block does not cull: ~30 FP32 operations
// (12 of them fused) and one IEEE division per test, plus 18 FMA-class
// operations and 3 divisions per (ray, instance) transform.
// What the design does about it: one thread per ray in 128-ray blocks.
// Each live lane slab-tests an instance's world AABB against its window
// (t_min, min(t_max, t_best)); the block skips the instance unless some
// lane passes (__syncthreads_or), which takes the place of the XLA
// bitmask prepass. For a surviving instance each lane transforms its
// ray, slab-tests each object-space group AABB the same way, and a group
// that some lane wants is staged once into 10 KB of shared memory and
// read as broadcasts. Any-hit lanes stop at their first hit, and the
// block leaves once every live lane is occluded. Front-to-back instance
// order, a BVH over instances and tensor cores are left to later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

namespace {

using namespace tpurt;

constexpr int GROUP = 256;      // triangles per object group (cull unit)
constexpr int BLOCK = 128;      // rays per block
constexpr int INST_COLS = 23;   // inst_table row width
using Group = Tris<GROUP>;

// The ray in instance space: row = inst_table row (A^-1 row-major | b).
__device__ __forceinline__ Ray to_object(const float* __restrict__ row,
                                         const Ray& w) {
    Ray obj;
    for (int k = 0; k < 3; ++k) {
        const float a0 = __ldg(row + 3 * k);
        const float a1 = __ldg(row + 3 * k + 1);
        const float a2 = __ldg(row + 3 * k + 2);
        obj.o[k] = __fmaf_rn(a2, w.o[2], __fmaf_rn(a1, w.o[1], a0 * w.o[0]))
                   + __ldg(row + 9 + k);
        obj.d[k] = __fmaf_rn(a2, w.d[2], __fmaf_rn(a1, w.d[1], a0 * w.d[0]));
        obj.inv[k] = safe_inv(obj.d[k]);
    }
    obj.t_min = w.t_min;
    obj.t_max = w.t_max;
    return obj;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
inst_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_min, const float* __restrict__ t_max,
            const float* __restrict__ planes, const float* __restrict__ gaabb,
            const float* __restrict__ inst_table,
            const float* __restrict__ inst_aabb,
            const int32_t* __restrict__ span, int R, int I, int NGO,
            float* __restrict__ t_out, int32_t* __restrict__ tri_out,
            int32_t* __restrict__ inst_out) {
    __shared__ Group sh;
    const int r = blockIdx.x * BLOCK + threadIdx.x;
    Ray ray = {};
    if (r < R) ray = load_ray(o, d, t_min, t_max, r, R);
    const bool live = r < R && ray.t_max > 0.0f;
    const int Tp = NGO * GROUP;
    float t_best = INF_T;
    int best = -1, best_inst = -1;
    bool hit = false;  // any-hit: occluded
    for (int i = 0; i < I; ++i) {
        // any-hit: leave once every live lane is occluded
        if (ANY && !__syncthreads_or(live && !hit)) break;
        const bool want_i =
            live && !hit &&
            slab_pass(inst_aabb + i * 8, 1, ray, ray.t_min,
                      ANY ? ray.t_max : fminf(ray.t_max, t_best));
        if (!__syncthreads_or(want_i)) continue;
        const Ray obj = to_object(inst_table + i * INST_COLS, ray);
        const int g0 = __ldg(span + i);
        const int g1 = g0 + __ldg(span + I + i);
        for (int g = g0; g < g1; ++g) {
            const float t_hi = ANY ? ray.t_max : fminf(ray.t_max, t_best);
            const bool want = want_i && !hit &&
                              slab_pass(gaabb + g, NGO, obj, obj.t_min, t_hi);
            if (!__syncthreads_or(want)) continue;
            stage<GROUP, BLOCK>(sh, planes, g * GROUP, Tp);
            __syncthreads();
            if (want) {
                if (ANY) {
                    for (int k = 0; k < GROUP && !hit; ++k) {
                        hit = intersect(sh, k, obj, ray.t_max) < INF_T;
                    }
                    if (hit) best_inst = i;
                } else {
                    for (int k = 0; k < GROUP; ++k) {
                        const float t = intersect(sh, k, obj,
                                                  fminf(ray.t_max, t_best));
                        if (t < t_best) {
                            t_best = t;
                            best = g * GROUP + k;
                            best_inst = i;
                        }
                    }
                }
            }
            __syncthreads();
        }
    }
    if (r < R) {
        if (ANY) {
            // the TPU any-hit contract: idx 1 or -1, t = t_max
            t_out[r] = ray.t_max;
            tri_out[r] = hit ? 1 : -1;
        } else {
            t_out[r] = best >= 0 ? t_best : INF_T;
            tri_out[r] = best;
        }
        inst_out[r] = best_inst;
    }
}

int launch(bool any_hit, const void* o, const void* d, const void* t_min,
           const void* t_max, const void* planes, const void* gaabb,
           const void* inst_table, const void* inst_aabb, const void* span,
           int R, int I, int NGO, void* t_out, void* tri_out, void* inst_out,
           void* stream) {
    if (R > 0) {
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = any_hit ? inst_kernel<true> : inst_kernel<false>;
        kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const float*>(planes),
            static_cast<const float*>(gaabb),
            static_cast<const float*>(inst_table),
            static_cast<const float*>(inst_aabb),
            static_cast<const int32_t*>(span), R, I, NGO,
            static_cast<float*>(t_out), static_cast<int32_t*>(tri_out),
            static_cast<int32_t*>(inst_out));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane). planes [4, 3, NGO * 256] object space; gaabb [8, NGO]
// object group AABBs; inst_table [I, 23]; inst_aabb [I, 8] world AABBs;
// span [2, I] i32 (first group, group count) inside [0, NGO). Outputs t
// [R] f32, tri [R] i32 (object triangle), inst [R] i32. Returns
// cudaGetLastError() after the launch.
int tpurt_inst_closest_hit(const void* o, const void* d, const void* t_min,
                           const void* t_max, const void* planes,
                           const void* gaabb, const void* inst_table,
                           const void* inst_aabb, const void* span, int R,
                           int I, int NGO, void* t_out, void* tri_out,
                           void* inst_out, void* stream) {
    return launch(false, o, d, t_min, t_max, planes, gaabb, inst_table,
                  inst_aabb, span, R, I, NGO, t_out, tri_out, inst_out,
                  stream);
}

int tpurt_inst_any_hit(const void* o, const void* d, const void* t_min,
                       const void* t_max, const void* planes,
                       const void* gaabb, const void* inst_table,
                       const void* inst_aabb, const void* span, int R, int I,
                       int NGO, void* t_out, void* tri_out, void* inst_out,
                       void* stream) {
    return launch(true, o, d, t_min, t_max, planes, gaabb, inst_table,
                  inst_aabb, span, R, I, NGO, t_out, tri_out, inst_out,
                  stream);
}

}  // extern "C"
