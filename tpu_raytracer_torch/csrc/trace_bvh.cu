// Stackless BVH walk of the PyTorch port, for Hopper (sm_90a).
//
//   K8  tpurt_bvh_closest_hit / tpurt_bvh_any_hit  replace
//       tpu_raytracer/ops/traversal.py `trace` (:28), the walk the
//       reference takes for every flattened scene past its cap of
//       triangle slots (ops/trace_api.py:45, 141-150). It is an XLA
//       while_loop there, not a Pallas kernel; here it is a kernel so
//       that a trace call reads the host once, not at every step.
//
// Semantics are the reference's walk, exactly, and its plain twin's
// (ops/traversal.py:trace_plain): each lane holds one pointer into the
// unified record stream (ops/bvh.py) and reads one record a step. A box
// record's slab test is the reference's, unpadded: the window
// (max(t_near, t_min), min(t_far, t_best)) with `<=`, so it visits no
// box the reference culls; a hit moves to the next record, a miss to the
// box's skip. A triangle record is tested by mt.cuh's mt_test (the plain
// version's FMAs as __fmaf_rn, built with -fmad=false) with t < t_best
// strict, so an exact-t tie goes to the earlier record in the stream,
// and the pointer moves on. Any-hit stops a lane at its first hit and
// writes that hit's (t, tri). A dead lane (t_max <= 0) takes no step
// and writes (INF, -1), as a miss does.
//
// What bounds it: for one walk, the records it reads, 48 bytes each,
// and one slab or Moller-Trumbore test per record; a 2.6M-triangle
// scene's stream is 4.25M records, 204 MB, beyond the 50 MB L2, and
// neighbouring rays read it in different orders. What the design does about it: one
// thread per ray, 128-thread blocks; a record is read as three float4
// through the read-only path (a box record only two), with its skip, so
// a step is one or two 16-byte loads per operand. Nothing is staged in
// shared memory and lanes of a warp diverge freely; a short stack, wide
// nodes, ray sorting or treelets in shared memory are left to later
// work.

#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

namespace {

using namespace tpurt;

constexpr int BLOCK = 128;

// A triangle record's planes as mt_test reads them: v0 | e1 | e2 in the
// record's first nine words; plane 3 (the validity row) reads 1.
struct RecordTri {
    float w[9];
    __device__ __forceinline__ float operator()(int p, int k) const {
        return p < 3 ? w[3 * p + k] : 1.0f;
    }
};

// The reference's slab test of a box record (min xyz | max xyz), no pad:
// traversal.py:78-84.
__device__ __forceinline__ bool box_hit(const float4& a, const float4& b,
                                        const Ray& ray, float t_best) {
    const float lo[3] = {a.x, a.y, a.z};
    const float hi[3] = {a.w, b.x, b.y};
    float t_near[3], t_far[3];
    for (int k = 0; k < 3; ++k) {
        const float t0 = (lo[k] - ray.o[k]) * ray.inv[k];
        const float t1 = (hi[k] - ray.o[k]) * ray.inv[k];
        t_near[k] = fminf(t0, t1);
        t_far[k] = fmaxf(t0, t1);
    }
    const float t_entry =
        fmaxf(fmaxf(fmaxf(t_near[0], t_near[1]), t_near[2]), ray.t_min);
    const float t_exit =
        fminf(fminf(fminf(t_far[0], t_far[1]), t_far[2]), t_best);
    return t_entry <= t_exit;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
bvh_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const float4* __restrict__ rec, const int32_t* __restrict__ skip,
           const int32_t* __restrict__ tri_id, int R, int S,
           float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
    const int r = blockIdx.x * BLOCK + threadIdx.x;
    if (r >= R) return;
    const Ray ray = load_ray(o, d, t_min, t_max, r, R);
    float t_best = ray.t_max;
    int32_t best = -1;
    int ptr = ray.t_max > 0.0f ? 0 : S;
    while (ptr < S) {
        const float4* row = rec + 3 * static_cast<int64_t>(ptr);
        const float4 a = __ldg(row);
        const float4 b = __ldg(row + 1);
        const int32_t sk = __ldg(skip + ptr);
        if (sk >= 0) {
            ptr = box_hit(a, b, ray, t_best) ? ptr + 1 : sk;
            continue;
        }
        const float4 c = __ldg(row + 2);
        const RecordTri tri{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x}};
        const float t = mt_test(tri, ray, t_best);
        if (t != INF_T) {
            t_best = t;
            best = __ldg(tri_id + ptr);
            if (ANY) break;
        }
        ++ptr;
    }
    t_out[r] = best >= 0 ? t_best : INF_T;
    tri_out[r] = best;
}

int launch(bool any_hit, const void* o, const void* d, const void* t_min,
           const void* t_max, const void* rec, const void* skip,
           const void* tri_id, int R, int S, void* t_out, void* tri_out,
           void* stream) {
    if (R > 0) {
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = any_hit ? bvh_kernel<true> : bvh_kernel<false>;
        kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const float4*>(rec), static_cast<const int32_t*>(skip),
            static_cast<const int32_t*>(tri_id), R, S,
            static_cast<float*>(t_out), static_cast<int32_t*>(tri_out));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane); rec [S, 12] f32, 16-byte aligned; skip and tri_id [S] i32
// (ops/bvh.py's stream). Outputs t [R] f32 and tri [R] i32: (INF, -1) on
// a miss; closest-hit gives the nearest hit, any-hit the first one the
// walk confirms. Returns cudaGetLastError() after the launch.
int tpurt_bvh_closest_hit(const void* o, const void* d, const void* t_min,
                          const void* t_max, const void* rec,
                          const void* skip, const void* tri_id, int R, int S,
                          void* t_out, void* tri_out, void* stream) {
    return launch(false, o, d, t_min, t_max, rec, skip, tri_id, R, S, t_out,
                  tri_out, stream);
}

int tpurt_bvh_any_hit(const void* o, const void* d, const void* t_min,
                      const void* t_max, const void* rec, const void* skip,
                      const void* tri_id, int R, int S, void* t_out,
                      void* tri_out, void* stream) {
    return launch(true, o, d, t_min, t_max, rec, skip, tri_id, R, S, t_out,
                  tri_out, stream);
}

}  // extern "C"
