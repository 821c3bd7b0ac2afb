// Device code shared by the traversal kernels (trace.cu: K1, K2;
// trace_inst.cu: K4; trace_stream.cu: K3; trace_vpu.cu: K5; trace_mxu.cu:
// K6, the ray record and slab test only): the ray record, the padded
// slab test, the order bits of t (K3, K4), staging of triangle planes
// into shared memory, and the exact-f32 Moller-Trumbore test. One copy,
// so every kernel runs the same arithmetic.
//
// The arithmetic is the plain versions' (ops/trace_api.py: slab_pass,
// mt_argmin), operation for operation: the multiply-adds
// that XLA:CPU fuses in the reference are explicit __fmaf_rn calls, and
// the library is built with -fmad=false so the compiler contracts
// nothing else.

#pragma once

#include <cuda_runtime.h>

namespace tpurt {

constexpr float INF_T = 3.0e38f;
constexpr float MT_EPS = 1e-9f;
constexpr float DIR_EPS = 1e-12f;

// N triangles' planes, staged once per block and read as broadcasts.
template <int N>
struct Tris {
    float v0[3][N];
    float e1[3][N];
    float e2[3][N];
    float valid[N];
};

struct Ray {
    float o[3], d[3], inv[3];
    float t_min, t_max;
};

// 1/d with |d| clamped to DIR_EPS (the slab test's reciprocal).
__device__ __forceinline__ float safe_inv(float d) {
    if (fabsf(d) < DIR_EPS) d = d < 0.0f ? -DIR_EPS : DIR_EPS;
    return 1.0f / d;
}

// Ray r of SoA rays: o and d [3, R], t_min and t_max [R].
__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        const float* t_min,
                                        const float* t_max, int r, int R) {
    Ray ray;
    for (int k = 0; k < 3; ++k) {
        ray.o[k] = o[k * R + r];
        ray.d[k] = d[k * R + r];
        ray.inv[k] = safe_inv(ray.d[k]);
    }
    ray.t_min = t_min[r];
    ray.t_max = t_max[r];
    return ray;
}

// The window (t_lo, t_hi) clipped to the padded slabs of one AABB;
// false for an empty box (min > max). box[k * stride] is min x, y, z for
// k = 0..2 and max x, y, z for k = 3..5 (stride 1 for [N, 8] rows, N for
// [8, N] columns). The box is padded by 1e-5 of its coordinates'
// magnitude (plus 1e-6), far above the rounding of both this test and
// the intersection test, so a box holding a triangle that the exact test
// would accept is never culled - flat walls give zero-thickness boxes.
// The box is read through the read-only cache, so it must lie in global
// memory.
__device__ __forceinline__ bool slab_window(const float* __restrict__ box,
                                            int stride, const Ray& ray,
                                            float& t_lo, float& t_hi) {
    auto at = [box](int i) { return __ldg(box + i); };
    if (!(at(0) <= at(3 * stride))) return false;
    for (int k = 0; k < 3; ++k) {
        float lo = at(k * stride);
        float hi = at((3 + k) * stride);
        float pad = 1e-5f * (fabsf(lo) + fabsf(hi)) + 1e-6f;
        float a = (lo - pad - ray.o[k]) * ray.inv[k];
        float b = (hi + pad - ray.o[k]) * ray.inv[k];
        t_lo = fmaxf(t_lo, fminf(a, b));
        t_hi = fminf(t_hi, fmaxf(a, b));
    }
    return true;
}

// Conservative slab test of one AABB in global memory against the window
// (t_lo, t_hi).
__device__ __forceinline__ bool slab_pass(const float* __restrict__ box,
                                          int stride, const Ray& ray,
                                          float t_lo, float t_hi) {
    return slab_window(box, stride, ray, t_lo, t_hi) && t_lo <= t_hi;
}

// float -> uint32 whose unsigned order is the float order
__device__ __forceinline__ unsigned order_bits(float x) {
    const unsigned u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned u) {
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The block's THREADS threads stage triangles first .. first + N - 1 of
// planes [4, 3, Tp], N / THREADS each (a loop the compiler unrolls).
template <int N, int THREADS>
__device__ __forceinline__ void stage(Tris<N>& sh,
                                      const float* __restrict__ planes,
                                      int first, int Tp) {
    static_assert(N % THREADS == 0, "whole triangles per thread");
#pragma unroll
    for (int j = 0; j < N / THREADS; ++j) {
        const int i = threadIdx.x + j * THREADS;
        const int g = first + i;
        for (int k = 0; k < 3; ++k) {
            sh.v0[k][i] = planes[(0 * 3 + k) * Tp + g];
            sh.e1[k][i] = planes[(1 * 3 + k) * Tp + g];
            sh.e2[k][i] = planes[(2 * 3 + k) * Tp + g];
        }
        sh.valid[i] = planes[(3 * 3) * Tp + g];
    }
}

// Moller-Trumbore in the operation order of the plain version against the
// triangle whose plane p (0 v0, 1 e1, 2 e2, 3 the validity row), component
// k, is `tri(p, k)`; returns t, or INF_T when the triangle is missed or t
// is outside (ray.t_min, t_hi).
template <class Tri>
__device__ __forceinline__ float mt_test(const Tri& tri, const Ray& ray,
                                         float t_hi) {
    const float dx = ray.d[0], dy = ray.d[1], dz = ray.d[2];
    const float e1x = tri(1, 0), e1y = tri(1, 1), e1z = tri(1, 2);
    const float e2x = tri(2, 0), e2y = tri(2, 1), e2z = tri(2, 2);
    // cross(a, b).x = fma(a.y, b.z, -(a.z * b.y));
    // dot(a, b) = fma(a.z, b.z, fma(a.y, b.y, a.x * b.x))
    const float px = __fmaf_rn(dy, e2z, -(dz * e2y));
    const float py = __fmaf_rn(dz, e2x, -(dx * e2z));
    const float pz = __fmaf_rn(dx, e2y, -(dy * e2x));
    const float det = __fmaf_rn(e1z, pz, __fmaf_rn(e1y, py, e1x * px));
    const bool ok = fabsf(det) > MT_EPS;
    const float inv = ok ? 1.0f / det : 0.0f;
    const float tx = ray.o[0] - tri(0, 0);
    const float ty = ray.o[1] - tri(0, 1);
    const float tz = ray.o[2] - tri(0, 2);
    const float u = __fmaf_rn(tz, pz, __fmaf_rn(ty, py, tx * px)) * inv;
    const float qx = __fmaf_rn(ty, e1z, -(tz * e1y));
    const float qy = __fmaf_rn(tz, e1x, -(tx * e1z));
    const float qz = __fmaf_rn(tx, e1y, -(ty * e1x));
    const float v = __fmaf_rn(dz, qz, __fmaf_rn(dy, qy, dx * qx)) * inv;
    const float t = __fmaf_rn(e2z, qz, __fmaf_rn(e2y, qy, e2x * qx)) * inv;
    const bool hit = ok && tri(3, 0) > 0.5f && u >= 0.0f && v >= 0.0f &&
                     u + v <= 1.0f && t > ray.t_min && t < t_hi;
    return hit ? t : INF_T;
}

// mt_test against staged triangle i.
template <int N>
__device__ __forceinline__ float intersect(const Tris<N>& sh, int i,
                                           const Ray& ray, float t_hi) {
    const auto tri = [&sh, i](int p, int k) {
        return p == 0 ? sh.v0[k][i]
               : p == 1 ? sh.e1[k][i]
               : p == 2 ? sh.e2[k][i]
                        : sh.valid[i];
    };
    return mt_test(tri, ray, t_hi);
}

}  // namespace tpurt
