// Front-to-back streamed traversal kernel of the PyTorch port, for Hopper
// (sm_90a).
//
//   K3  tpurt_stream_closest_hit / tpurt_stream_any_hit  replace
//       tpu_raytracer/ops/pallas_trace.py `_mt_kernel_mxus` (:800), the
//       kernel the reference runs for every flattened scene past 32,768
//       triangle slots, and its feeders: the worklist prepass
//       `_block_entry` (:1326) and the entry sort (:1626-1628).
//
// Semantics are K1's (trace.cu), exactly: the exact-f32 Moller-Trumbore
// test of mt.cuh, the semantics of `_trace_brute_xla`. An exact-t tie
// goes to the lowest triangle id whatever the sweep order, because each
// lane keeps (t, id) lexicographically; the TPU kernel breaks such ties
// in worklist order, which the port does not copy. Any-hit returns K2's
// contract: tri 1 / -1 and t = t_max.
//
// What bounds it on this card: slab and Moller-Trumbore issue, and
// divergence, not HBM. The knot's planes are 100,864 slots x 48 B =
// 4.84 MB and stay in the 50 MB L2; a ray tests ~30 FP32 operations (12
// fused) and one IEEE division per triangle of every 128-triangle chunk
// its block sweeps, and one 24-operation slab test per chunk box and
// lane for the worklist.
// What the design does about it, per 128-ray block (one thread a ray):
//   1. Worklist. Each thread takes units u, u + 128, ... (a unit is GRP
//      consecutive chunks) and slab-tests the unit's chunk boxes against
//      every live lane's (t_min, t_max) with the lanes read from shared
//      memory as broadcasts: the unit's entry is the block minimum of
//      `slab_entry`, INF_T where no lane reaches it. grp is the smallest
//      power of two that keeps ceil(chunks / grp) <= MAX_UNITS (the
//      knot's 788 chunks give grp = 1).
//   2. Sort. A bitonic sort of (entry bits, unit id) keys in shared
//      memory orders the units front to back; units no lane reaches sort
//      last and are dropped.
//   3. Sweep with early exit. Units are swept in that order, each of
//      their chunks staged into a two-slot shared-memory ring by cp.async
//      one step ahead of the chunk being tested. Closest-hit leaves once
//      every live lane's best t is strictly below the next unit's entry,
//      a conservative lower bound on any hit in it, so the exit changes
//      no result; any-hit leaves once every live lane is occluded. A
//      chunk that no lane's current window reaches is skipped, as K1
//      does. The copy still in flight is waited for before the block
//      leaves (the drain of pallas_trace.py:1046-1057).
// Tensor cores and a persistent grid are left to later work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

namespace {

using namespace tpurt;

constexpr int CT = 128;           // triangles per chunk
constexpr int BLOCK = CT;         // rays per block
// worklist capacity (16 KB of keys); a smaller build-time value makes
// units of several chunks on small scenes, for tests
#ifndef TPURT_MAX_UNITS
#define TPURT_MAX_UNITS 2048
#endif
constexpr int MAX_UNITS = TPURT_MAX_UNITS;
constexpr int ROWS = 10;          // float rows of a chunk: v0, e1, e2, valid
constexpr int PIECES = ROWS * CT / 4;   // 16-byte copies per chunk
using Chunk = Tris<CT>;
using Key = unsigned long long;

struct Shared {
    Chunk ring[2];           // the staging ring, 2 x 5 KB
    Key key[MAX_UNITS];      // (entry bits << 32) | unit id
    Ray rays[BLOCK];         // the block's rays, for the worklist
};

// float -> uint32 whose unsigned order is the float order
__device__ __forceinline__ unsigned order_bits(float x) {
    const unsigned u = __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float entry_of(Key k) {
    const unsigned u = static_cast<unsigned>(k >> 32);
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Every thread's share of chunk c's ten 512-byte rows of planes
// [4, 3, Tp] into `dst`, as 16-byte asynchronous copies.
__device__ __forceinline__ void issue(Chunk& dst,
                                      const float* __restrict__ planes,
                                      int c, int Tp) {
    float* out = reinterpret_cast<float*>(&dst);
    for (int j = threadIdx.x; j < PIECES; j += BLOCK) {
        const int row = j / (CT / 4);
        const int col = (j % (CT / 4)) * 4;
        __pipeline_memcpy_async(out + row * CT + col,
                                planes + row * Tp + c * CT + col, 16);
    }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
stream_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_min,
              const float* __restrict__ t_max,
              const float* __restrict__ planes,
              const float* __restrict__ aabb, int R, int Tp, int grp,
              int n_units, int sort_n, float* __restrict__ t_out,
              int32_t* __restrict__ tri_out) {
    __shared__ __align__(16) Shared sh;
    const int tid = threadIdx.x;
    const int r = blockIdx.x * BLOCK + tid;
    Ray ray = {};
    if (r < R) ray = load_ray(o, d, t_min, t_max, r, R);
    const bool live = r < R && ray.t_max > 0.0f;
    sh.rays[tid] = ray;             // a dead lane has t_max <= 0
    __syncthreads();

    // 1. worklist: the block's entry distance of each unit
    const int nc = Tp / CT;
    for (int u = tid; u < sort_n; u += BLOCK) {
        float e = INF_T;
        const int c1 = min((u + 1) * grp, nc);
        for (int c = u * grp; u < n_units && c < c1; ++c) {
            float box[6];
            for (int k = 0; k < 6; ++k) box[k] = __ldg(aabb + c * 8 + k);
            for (int l = 0; l < BLOCK; ++l) {
                const Ray& q = sh.rays[l];
                if (q.t_max > 0.0f) {
                    e = fminf(e, slab_entry(box, 1, q, q.t_min, q.t_max));
                }
            }
        }
        sh.key[u] = u < n_units
                        ? (static_cast<Key>(order_bits(e)) << 32) |
                              static_cast<unsigned>(u)
                        : ~0ull;
    }
    __syncthreads();

    // 2. bitonic sort, ascending by (entry, unit id)
    for (int k = 2; k <= sort_n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < sort_n; i += BLOCK) {
                const int p = i ^ j;
                if (p > i) {
                    const Key a = sh.key[i], b = sh.key[p];
                    if ((a > b) == ((i & k) == 0)) {
                        sh.key[i] = b;
                        sh.key[p] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
    // units some lane reaches: the keys below INF_T's
    const unsigned inf_bits = order_bits(INF_T);
    int n_live = 0, hi = n_units;
    while (n_live < hi) {
        const int mid = (n_live + hi) / 2;
        if (static_cast<unsigned>(sh.key[mid] >> 32) < inf_bits) {
            n_live = mid + 1;
        } else {
            hi = mid;
        }
    }

    // 3. front-to-back sweep, one chunk a step, staged one step ahead
    const int n_steps = n_live * grp;
    float t_best = INF_T;
    int best = -1;
    bool hit = false;      // any-hit: occluded
    int c_next = n_steps > 0
                     ? static_cast<int>(sh.key[0] & 0xffffffffu) * grp
                     : nc;
    if (c_next < nc) issue(sh.ring[0], planes, c_next, Tp);
    __pipeline_commit();
    for (int s = 0; s < n_steps; ++s) {
        const int c = c_next;
        const int s1 = s + 1;
        c_next = s1 < n_steps
                     ? static_cast<int>(sh.key[s1 / grp] & 0xffffffffu) *
                               grp + s1 % grp
                     : nc;
        if (c_next < nc) issue(sh.ring[s1 & 1], planes, c_next, Tp);
        __pipeline_commit();
        __pipeline_wait_prior(1);   // this step's copies have landed
        __syncthreads();
        if (c < nc) {
            const bool want =
                live && !hit &&
                slab_pass(aabb + c * 8, 1, ray, ray.t_min,
                          ANY ? ray.t_max : fminf(ray.t_max, t_best));
            if (__syncthreads_or(want) && want) {
                const Chunk& ch = sh.ring[s & 1];
                if (ANY) {
                    for (int i = 0; i < CT && !hit; ++i) {
                        hit = intersect(ch, i, ray, ray.t_max) < INF_T;
                    }
                } else {
                    for (int i = 0; i < CT; ++i) {
                        const float t = intersect(ch, i, ray, ray.t_max);
                        const int id = c * CT + i;
                        // (t, id) lexicographically: a tie with an
                        // earlier-swept unit goes to the lower id
                        if (t < t_best || (t == t_best && id < best)) {
                            t_best = t;
                            best = id;
                        }
                    }
                }
            }
        }
        __syncthreads();   // the slot is read before it is staged again
        bool stop = false;
        if (ANY) {
            stop = !__syncthreads_or(live && !hit);
        } else if (s % grp == grp - 1 && s1 < n_steps) {
            const float next = entry_of(sh.key[s1 / grp]);
            stop = !__syncthreads_or(live && !(t_best < next));
        }
        if (stop) break;
    }
    __pipeline_wait_prior(0);   // drain the copy still in flight, if any

    if (r < R) {
        if (ANY) {
            // the TPU any-hit contract: idx 1 or -1, t = t_max
            t_out[r] = ray.t_max;
            tri_out[r] = hit ? 1 : -1;
        } else {
            t_out[r] = best >= 0 ? t_best : INF_T;
            tri_out[r] = best;
        }
    }
}

int launch(bool any_hit, const void* o, const void* d, const void* t_min,
           const void* t_max, const void* planes, const void* aabb, int R,
           int Tp, void* t_out, void* tri_out, void* stream) {
    if (R > 0) {
        const int nc = Tp / CT;
        int grp = 1;
        while ((nc + grp - 1) / grp > MAX_UNITS) grp <<= 1;
        const int n_units = (nc + grp - 1) / grp;
        int sort_n = 1;
        while (sort_n < n_units) sort_n <<= 1;
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = any_hit ? stream_kernel<true> : stream_kernel<false>;
        kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const float*>(planes), static_cast<const float*>(aabb),
            R, Tp, grp, n_units, sort_n, static_cast<float*>(t_out),
            static_cast<int32_t*>(tri_out));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane); planes [4, 3, Tp] with Tp a multiple of 128 and a 16-byte
// aligned base; aabb [Tp/128, 8]. Outputs t [R] f32 and tri [R] i32.
// Returns cudaGetLastError() after the launch.
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
