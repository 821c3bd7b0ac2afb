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
// operation for operation: the multiply-adds that XLA:CPU fuses in the
// reference are explicit __fmaf_rn calls, and the library is built with
// -fmad=false so the compiler contracts nothing else. K1 therefore
// returns the plain version's (t, tri) bit for bit, including the
// exact-t ties where two triangles meet at an edge.
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

namespace {

constexpr int CT = 128;         // triangles per chunk (cull granularity)
constexpr int BLOCK = CT;       // rays per block: thread i stages triangle i
constexpr float INF_T = 3.0e38f;
constexpr float MT_EPS = 1e-9f;
constexpr float DIR_EPS = 1e-12f;

struct Chunk {
    float v0[3][CT];
    float e1[3][CT];
    float e2[3][CT];
    float valid[CT];
};

struct Ray {
    float o[3], d[3], inv[3];
    float t_min, t_max;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* t_min,
                                        const float* t_max, int r, int R) {
    Ray ray;
    for (int k = 0; k < 3; ++k) {
        ray.o[k] = o[k * R + r];
        ray.d[k] = d[k * R + r];
        float dk = ray.d[k];
        if (fabsf(dk) < DIR_EPS) dk = dk < 0.0f ? -DIR_EPS : DIR_EPS;
        ray.inv[k] = 1.0f / dk;
    }
    ray.t_min = t_min[r];
    ray.t_max = t_max[r];
    return ray;
}

// Conservative slab test of chunk c's AABB against the window (t_lo,
// t_hi). The box is padded by 1e-5 of its coordinates' magnitude (plus
// 1e-6), far above the rounding of both this test and the intersection
// test, so a chunk holding a triangle that the exact test would accept is
// never culled - flat walls give zero-thickness boxes.
__device__ __forceinline__ bool slab_pass(const float* __restrict__ aabb,
                                          int c, const Ray& ray,
                                          float t_lo, float t_hi) {
    const float* box = aabb + c * 8;
    if (!(__ldg(box) <= __ldg(box + 3))) return false;  // empty chunk
    for (int k = 0; k < 3; ++k) {
        float lo = __ldg(box + k);
        float hi = __ldg(box + 3 + k);
        float pad = 1e-5f * (fabsf(lo) + fabsf(hi)) + 1e-6f;
        float a = (lo - pad - ray.o[k]) * ray.inv[k];
        float b = (hi + pad - ray.o[k]) * ray.inv[k];
        t_lo = fmaxf(t_lo, fminf(a, b));
        t_hi = fminf(t_hi, fmaxf(a, b));
    }
    return t_lo <= t_hi;
}

__device__ __forceinline__ void stage_chunk(Chunk& sh,
                                            const float* __restrict__ planes,
                                            int c, int Tp) {
    int g = c * CT + threadIdx.x;
    for (int k = 0; k < 3; ++k) {
        sh.v0[k][threadIdx.x] = planes[(0 * 3 + k) * Tp + g];
        sh.e1[k][threadIdx.x] = planes[(1 * 3 + k) * Tp + g];
        sh.e2[k][threadIdx.x] = planes[(2 * 3 + k) * Tp + g];
    }
    sh.valid[threadIdx.x] = planes[(3 * 3) * Tp + g];
}

// Moller-Trumbore in the operation order of the plain version; returns t,
// or a value that fails `t < t_hi` when the triangle is missed.
__device__ __forceinline__ float intersect(const Chunk& sh, int i,
                                           const Ray& ray, float t_hi) {
    const float dx = ray.d[0], dy = ray.d[1], dz = ray.d[2];
    const float e1x = sh.e1[0][i], e1y = sh.e1[1][i], e1z = sh.e1[2][i];
    const float e2x = sh.e2[0][i], e2y = sh.e2[1][i], e2z = sh.e2[2][i];
    // cross(a, b).x = fma(a.y, b.z, -(a.z * b.y));
    // dot(a, b) = fma(a.z, b.z, fma(a.y, b.y, a.x * b.x))
    const float px = __fmaf_rn(dy, e2z, -(dz * e2y));
    const float py = __fmaf_rn(dz, e2x, -(dx * e2z));
    const float pz = __fmaf_rn(dx, e2y, -(dy * e2x));
    const float det = __fmaf_rn(e1z, pz, __fmaf_rn(e1y, py, e1x * px));
    const bool ok = fabsf(det) > MT_EPS;
    const float inv = ok ? 1.0f / det : 0.0f;
    const float tx = ray.o[0] - sh.v0[0][i];
    const float ty = ray.o[1] - sh.v0[1][i];
    const float tz = ray.o[2] - sh.v0[2][i];
    const float u = __fmaf_rn(tz, pz, __fmaf_rn(ty, py, tx * px)) * inv;
    const float qx = __fmaf_rn(ty, e1z, -(tz * e1y));
    const float qy = __fmaf_rn(tz, e1x, -(tx * e1z));
    const float qz = __fmaf_rn(tx, e1y, -(ty * e1x));
    const float v = __fmaf_rn(dz, qz, __fmaf_rn(dy, qy, dx * qx)) * inv;
    const float t = __fmaf_rn(e2z, qz, __fmaf_rn(e2y, qy, e2x * qx)) * inv;
    const bool hit = ok && sh.valid[i] > 0.5f && u >= 0.0f && v >= 0.0f &&
                     u + v <= 1.0f && t > ray.t_min && t < t_hi;
    return hit ? t : INF_T;
}

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
        const bool want = live && slab_pass(aabb, c, ray, ray.t_min, t_hi);
        if (!__syncthreads_or(want)) continue;
        stage_chunk(sh, planes, c, Tp);
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
                          slab_pass(aabb, c, ray, ray.t_min, ray.t_max);
        if (!__syncthreads_or(want)) continue;
        stage_chunk(sh, planes, c, Tp);
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
