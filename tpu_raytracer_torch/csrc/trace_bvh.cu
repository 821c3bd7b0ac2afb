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
// unified record stream (ops/bvh.py) and takes one record a step. A box
// record's slab test is the reference's, unpadded: the window
// (max(t_near, t_min), min(t_far, t_best)) with `<=`, so it visits no
// box the reference culls; a hit moves to the next record, a miss to the
// box's skip. A triangle record is tested by mt.cuh's mt_test (the plain
// version's FMAs as __fmaf_rn, built with -fmad=false) with t < t_best
// strict, so an exact-t tie goes to the earlier record in the stream,
// and the pointer moves on. Any-hit stops a lane at its first hit and
// writes that hit's (t, tri). A dead lane (t_max <= 0) takes no step
// and writes (INF, -1), as a miss does. Every ray visits the records of
// the reference's depth-first order, in that order, whatever the window
// below: it changes when records are loaded, never a ray's own sequence.
//
// What bounds it. The bytes bound counts each touched record once (a
// 2.6M-triangle scene's stream is 4.25M records, 204 MB, beyond the 50
// MB L2); the kernel runs 20-25x past it. Each step of a ray is a
// dependent load (the record decides the next pointer), and the walk's
// steps are long-tailed: on that scene's 262,144 incoherent rays a
// closest-hit ray takes 11 steps on the mean, the p99 160, the longest
// 678 (5 and up to 221 of them box misses, jumps). The longest 1% of
// rays set the time: without them K8 takes 35% of it, they alone 80%,
// at about 0.39 us a step on the H100 (PERF.md §6). A fall-through
// step's record lies next to the last one; a jump's lies far off, in
// DRAM.
// What the design does about it: windowed record loads
// (TPURT_BVH_WINDOW = W, 3). A lane loads the W records from its
// pointer on (a box needs 6 words, a triangle 9: each record's first two
// float4 and its ninth word) and their skip words as independent loads
// issued back to back, then takes them while the walk falls through to
// ptr + 1 or skips to a record still inside the window (one unrolled
// slot a record, taken when the pointer reaches it; a skip is always
// forward). Only a skip past the window, or its end, issues the next
// load. The DFS layout makes this pay: a run of box hits down the tree
// is contiguous and a leaf's triangles follow its box. A window near the
// stream's end is clamped at S (bvh_rec has no pad); tri_id is read only
// on a hit. It saves the fall-through loads, not the jumps, and costs
// registers and the window's bytes a record. One thread takes one ray,
// in blocks of 128, and writes its result at its own index.
// The window is the fastest build on the 2.6M-triangle scene's 262,144
// incoherent rays, weighing closest- and any-hit by their 15 and 7
// launches a frame (tpu_raytracer_torch/bvh_variants.py). PERF.md §6
// holds every build's times and the designs that lost: persistent warps
// that refill idle lanes (Aila and Laine, HPG 2009; slower while a call
// fits the card at once, as the main path's do), skip prefetch, record
// selects, a late ninth word, register and grid caps.

#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

#ifndef TPURT_BVH_WINDOW
#define TPURT_BVH_WINDOW 3
#endif

namespace {

using namespace tpurt;

constexpr int W = TPURT_BVH_WINDOW;
constexpr int BLOCK = 128;
static_assert(W >= 1 && W <= 16, "window of 1-16 records");

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

// One lane's walk state: its ray, running best and stream pointer
// (ptr >= S: done).
struct Walk {
    Ray ray;
    float t_best;
    int32_t best;
    int ptr;
};

// One record of the walk, at w.ptr: its first two float4, its ninth
// word c and its skip word.
template <bool ANY>
__device__ __forceinline__ void step(Walk& w, const float4& a,
                                     const float4& b, float c, int32_t sk,
                                     const int32_t* __restrict__ tri_id,
                                     int S) {
    if (sk >= 0) {
        w.ptr = box_hit(a, b, w.ray, w.t_best) ? w.ptr + 1 : sk;
        return;
    }
    const RecordTri tri{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c}};
    const float t = mt_test(tri, w.ray, w.t_best);
    if (t != INF_T) {
        w.t_best = t;
        w.best = __ldg(tri_id + w.ptr);
    }
    w.ptr = ANY && t != INF_T ? S : w.ptr + 1;
}

// Load the window at w.ptr (w.ptr < S) and take its records while the
// walk stays inside it: one unrolled slot a record, each taken when the
// pointer reaches it (a skip is always forward). On return w.ptr is
// past the window, at a skip outside it, or S (done; any-hit sets it at
// its first hit).
template <bool ANY>
__device__ __forceinline__ void window(Walk& w,
                                       const float4* __restrict__ rec,
                                       const int32_t* __restrict__ skip,
                                       const int32_t* __restrict__ tri_id,
                                       int S) {
    const int base = w.ptr;
    const int n = min(W, S - base);
    const float4* row = rec + 3 * static_cast<int64_t>(base);
    float4 a[W], b[W];
    float c[W];
    int32_t sk[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
        if (i < n) {
            a[i] = __ldg(row + 3 * i);
            b[i] = __ldg(row + 3 * i + 1);
            c[i] = __ldg(reinterpret_cast<const float*>(row + 3 * i + 2));
            sk[i] = __ldg(skip + base + i);
        }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
        if (i < n && w.ptr == base + i)
            step<ANY>(w, a[i], b[i], c[i], sk[i], tri_id, S);
    }
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
    Walk w;
    w.ray = load_ray(o, d, t_min, t_max, r, R);
    w.t_best = w.ray.t_max;
    w.best = -1;
    w.ptr = w.ray.t_max > 0.0f ? 0 : S;
    while (w.ptr < S) window<ANY>(w, rec, skip, tri_id, S);
    t_out[r] = w.best >= 0 ? w.t_best : INF_T;
    tri_out[r] = w.best;
}

int launch(bool any_hit, const void* o, const void* d, const void* t_min,
           const void* t_max, const void* rec, const void* skip,
           const void* tri_id, int R, int S, void* t_out, void* tri_out,
           void* stream) {
    if (R > 0) {
        const dim3 grid(static_cast<unsigned>(
            (static_cast<int64_t>(R) + BLOCK - 1) / BLOCK));
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
