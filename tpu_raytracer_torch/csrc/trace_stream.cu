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
// test of mt.cuh, the semantics of `_trace_brute_xla`. Each lane keeps the
// lexicographic minimum of (t, triangle id), so an exact-t tie goes to the
// lowest id whatever the sweep order; the TPU kernel breaks such ties in
// worklist order, which the port does not copy. Any-hit returns K2's
// contract: tri 1 / -1 and t = t_max.
//
// What bounds it on this card: instruction issue (the exact tests, the
// slab tests that pick them, and the block's fixed cost per step), not
// HBM: the knot's planes are 100,864 slots x 48 B = 4.84 MB and stay in
// the 50 MB L2. Incoherent rays want few chunks each (about 7 of the
// knot's 788 at their t_max windows), but a block of 128 such rays wants
// ~340 of them, so a sweep with one thread a ray runs every lane through
// the union of its warp's chunks (25x the tests the lanes want), a
// worklist that slab-tests every chunk box against every lane costs as
// much as the tests, and a block barrier per chunk costs more than the
// chunk's few tests.
// What the design does about it, per 128-ray block:
//   1. Unit boxes. A unit is GRP consecutive chunks, GRP the smallest power
//      of two that keeps the units within MAX_UNITS (the knot: 16 chunks,
//      50 units). Thread u folds unit u's box from its chunks' boxes, each
//      padded as mt.cuh:slab_window pads it, so the unit box holds every
//      padded chunk box and its (unpadded) slab entry is a lower bound on
//      any hit in the unit. Each lane slab-tests each unit once; a ballot
//      keeps a pass bit per unit and lane, and a warp minimum the block's
//      entry into each unit.
//   2. Sort. Each unit's (entry, id) key is ranked against the others in
//      shared memory; units no lane reaches rank last and are dropped.
//   3. Segments. Units go front to back, in segments of up to 32 chunks.
//      The lanes that passed the unit's box are compacted into a list
//      (ballot and popc per warp), and the (lane, chunk) slab tests against
//      each lane's window so far are spread over the block: they set, for
//      each chunk, the bit mask of the lanes that want it. A chunk no lane
//      wants is not staged. Two block barriers a segment: none a chunk.
//   4. Tests. For each wanted chunk, thread j holds triangle j and tests it
//      against every lane of the chunk's mask, its ray read from shared
//      memory as a broadcast: the tests issued follow the lanes that want a
//      chunk, not the warps that hold one such lane.
//   5. Hits. Closest-hit folds (order bits of t << 32 | id) into the lane's
//      64-bit key with a shared atomicMin: the minimum of the keys is the
//      lexicographic minimum whatever the order of the atomics. The window
//      of the test stays (t_min, t_max): a narrower one would drop an
//      equal-t triangle with a lower id. Any-hit sets the lane's flag.
//   6. Exits, at segment boundaries. Closest-hit leaves before a unit once
//      every live lane's best t is strictly below the unit's entry, a lower
//      bound on any hit in it and in every later unit, so the exit changes
//      no result; any-hit leaves once every live lane is occluded.
//   7. Loads. Thread j needs triangle j of a chunk and nothing else, so
//      it loads it from global memory (L2) into registers one wanted chunk
//      ahead of the one it tests: ten coalesced 512-byte rows a chunk, no
//      shared memory and no barrier. A ring of 3 chunks fed by bulk
//      asynchronous copies on full/empty mbarriers measured 17-19% slower
//      on the knot's random rays and no faster on its primary rays on the
//      H100 (PERF.md §6), and was dropped.

#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

namespace {

using namespace tpurt;

constexpr int CT = 128;           // triangles per chunk
constexpr int BLOCK = CT;         // rays per block; thread j tests triangle j
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
// unit capacity; a smaller build-time value makes units of more chunks
// (the g++ emulation's tests build 16 and 8)
#ifndef TPURT_MAX_UNITS
#define TPURT_MAX_UNITS 64
#endif
constexpr int MAX_UNITS = TPURT_MAX_UNITS;
static_assert(MAX_UNITS <= BLOCK, "one thread folds and ranks each unit");
constexpr int SEG = 32;           // chunks in one mask word
static_assert(SEG * WARPS == BLOCK, "a thread clears a word of cmask");
constexpr int ROWS = 10;          // float rows of a chunk: v0, e1, e2, valid
using Key = unsigned long long;

struct Shared {
    float4 ro[BLOCK], rd[BLOCK];     // the lanes' (o, t_min), (d, t_max)
    float4 ri[BLOCK];                // (1/d, unused)
    Key key[BLOCK];                  // closest: (t bits << 32) | id a lane
    int occ[BLOCK];                  // any-hit: the lane is occluded
    int n_occ;                       // any-hit: occluded lanes
    float ubox[MAX_UNITS][6];        // the units' padded boxes
    unsigned uentry[MAX_UNITS];      // order bits of the block's entry
    Key ukey[MAX_UNITS];             // (entry bits << 32) | unit, sorted
    unsigned ubits[MAX_UNITS][WARPS];  // a lane passed the unit's box
    int list[BLOCK];                 // a segment's lanes, 32 slots a warp
    int cnt[WARPS];                  // and their count a warp
    unsigned smask[2];               // a segment's chunks some lane wants
    unsigned cmask[2][SEG][WARPS];   // the lanes that want each chunk
};

// The slab entry of the window (t_lo, t_hi) into a box that is already
// padded (a unit box), else INF_T; box [6] is min xyz, max xyz.
__device__ __forceinline__ float box_entry(const float* box, const Ray& ray,
                                           float t_lo, float t_hi) {
    if (!(box[0] <= box[3])) return INF_T;
    for (int k = 0; k < 3; ++k) {
        const float a = (box[k] - ray.o[k]) * ray.inv[k];
        const float b = (box[3 + k] - ray.o[k]) * ray.inv[k];
        t_lo = fmaxf(t_lo, fminf(a, b));
        t_hi = fminf(t_hi, fmaxf(a, b));
    }
    return t_lo <= t_hi ? t_lo : INF_T;
}

// This thread's triangle of chunk c straight from global memory.
__device__ __forceinline__ void load_tri(const float* __restrict__ planes,
                                         int c, int Tp, float* tv) {
    for (int row = 0; row < ROWS; ++row) {
        tv[row] = __ldg(planes + row * Tp + c * CT + threadIdx.x);
    }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
stream_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_min,
              const float* __restrict__ t_max,
              const float* __restrict__ planes,
              const float* __restrict__ aabb, int R, int Tp, int grp,
              int n_units, float* __restrict__ t_out,
              int32_t* __restrict__ tri_out) {
    __shared__ __align__(128) Shared sh;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;   // lanes before this one
    const int r = blockIdx.x * BLOCK + tid;
    const int nc = Tp / CT;
    Ray ray = {};
    if (r < R) ray = load_ray(o, d, t_min, t_max, r, R);
    const bool live = r < R && ray.t_max > 0.0f;
    sh.ro[tid] = make_float4(ray.o[0], ray.o[1], ray.o[2], ray.t_min);
    sh.rd[tid] = make_float4(ray.d[0], ray.d[1], ray.d[2], ray.t_max);
    sh.ri[tid] = make_float4(ray.inv[0], ray.inv[1], ray.inv[2], 0.0f);
    sh.key[tid] = ~0ull;
    sh.occ[tid] = 0;
    if (tid == 0) sh.n_occ = 0;

    // 1. unit boxes from the padded chunk boxes, as slab_window pads them
    if (tid < n_units) {
        float box[6] = {INF_T, INF_T, INF_T, -INF_T, -INF_T, -INF_T};
        for (int c = tid * grp; c < min((tid + 1) * grp, nc); ++c) {
            const float* b = aabb + c * 8;
            if (!(__ldg(b) <= __ldg(b + 3))) continue;    // an empty chunk
            for (int k = 0; k < 3; ++k) {
                const float lo = __ldg(b + k), hi = __ldg(b + 3 + k);
                const float pad = 1e-5f * (fabsf(lo) + fabsf(hi)) + 1e-6f;
                box[k] = fminf(box[k], lo - pad);
                box[3 + k] = fmaxf(box[3 + k], hi + pad);
            }
        }
        for (int k = 0; k < 6; ++k) sh.ubox[tid][k] = box[k];
        sh.uentry[tid] = order_bits(INF_T);
    }
    const int n_lanes = __syncthreads_count(live);

    // each lane's pass bit of each unit box; the block's entry into it
    for (int u = 0; u < n_units; ++u) {
        const float e = live ? box_entry(sh.ubox[u], ray, ray.t_min,
                                         ray.t_max)
                             : INF_T;
        const unsigned bits = __ballot_sync(FULL, e < INF_T);
        const unsigned first = __reduce_min_sync(FULL, order_bits(e));
        if (lane == 0) {
            sh.ubits[u][warp] = bits;
            atomicMin(&sh.uentry[u], first);
        }
    }
    __syncthreads();

    // 2. sort: each unit's key goes to its rank by (entry, unit id)
    Key mine = ~0ull;
    if (tid < n_units) {
        mine = (static_cast<Key>(sh.uentry[tid]) << 32) |
               static_cast<unsigned>(tid);
        sh.ukey[tid] = mine;
    }
    __syncthreads();
    int rank = 0;
    if (tid < n_units) {
        for (int v = 0; v < n_units; ++v) rank += sh.ukey[v] < mine;
    }
    __syncthreads();
    if (tid < n_units) sh.ukey[rank] = mine;
    int n_live = 0;         // units some lane reaches
    const unsigned inf_bits = order_bits(INF_T);
    for (int v = 0; v < n_units; ++v) n_live += sh.uentry[v] < inf_bits;
    __syncthreads();

    // 3. front-to-back sweep, segment by segment
    int sp = 0;                 // parity of the mask buffers
    bool done = false;
    for (int p = 0; p < n_live && !done; ++p) {
        const Key uk = sh.ukey[p];
        const int u = static_cast<int>(uk & 0xffffffffu);
        const float entry = from_order_bits(static_cast<unsigned>(uk >> 32));
        const bool in_unit = live && ((sh.ubits[u][warp] >> lane) & 1u);
        const int c0 = u * grp, c1 = min(c0 + grp, nc);
        for (int seg = c0; seg < c1; seg += SEG) {
            const int n = min(SEG, c1 - seg);
            const int sb = sp;
            sp ^= 1;
            // the lanes that passed the unit's box, compacted (any-hit: an
            // occluded lane drops out; a flag set since the last barrier
            // may not show yet, and the pair test reads it again)
            const bool in = in_unit && !(ANY && sh.occ[tid]);
            const unsigned ins = __ballot_sync(FULL, in);
            if (in) sh.list[warp * 32 + __popc(ins & below)] = tid;
            if (lane == 0) sh.cnt[warp] = __popc(ins);
            (&sh.cmask[sb][0][0])[tid] = 0;
            if (tid == 0) sh.smask[sb] = 0;
            __syncthreads();    // the list; the last segment's hits folded
            if (ANY && sh.n_occ == n_lanes) {
                done = true;
                break;
            }
            const Key mine = sh.key[tid];
            const float t_best =
                mine == ~0ull ? INF_T
                              : from_order_bits(static_cast<unsigned>(
                                    mine >> 32));
            // where each warp's lanes start in the compacted order
            const int o1 = sh.cnt[0], o2 = o1 + sh.cnt[1],
                      o3 = o2 + sh.cnt[2];
            // each (listed lane, chunk) pair's slab test against the lane's
            // window so far, spread over the block: the lanes that want
            // each chunk, and the chunks some lane wants
            const int pairs = (o3 + sh.cnt[3]) * n;
            for (int base = 0; base < pairs; base += BLOCK) {
                const int i = base + tid;
                unsigned bit = 0;
                if (i < pairs) {
                    const int k = i / n, j = i - k * n;
                    const int w = (k >= o1) + (k >= o2) + (k >= o3);
                    const int first = w == 0 ? 0 : w == 1 ? o1
                                      : w == 2 ? o2 : o3;
                    const int l = sh.list[w * 32 + k - first];
                    const float4 a = sh.ro[l], b = sh.ri[l];
                    float hi = sh.rd[l].w;
                    bool open = true;
                    if (ANY) {
                        open = !sh.occ[l];
                    } else if (sh.key[l] != ~0ull) {
                        hi = fminf(hi, from_order_bits(static_cast<unsigned>(
                                           sh.key[l] >> 32)));
                    }
                    Ray q = {};
                    q.o[0] = a.x;
                    q.o[1] = a.y;
                    q.o[2] = a.z;
                    q.inv[0] = b.x;
                    q.inv[1] = b.y;
                    q.inv[2] = b.z;
                    if (open &&
                        slab_pass(aabb + (seg + j) * 8, 1, q, a.w, hi)) {
                        bit = 1u << j;
                        atomicOr(&sh.cmask[sb][j][l >> 5], 1u << (l & 31));
                    }
                }
                const unsigned wm = __reduce_or_sync(FULL, bit);
                if (lane == 0 && wm) atomicOr(&sh.smask[sb], wm);
            }
            // the closest-hit exit, before each unit
            const bool open =
                ANY || seg != c0 || (live && !(t_best < entry));
            if (!__syncthreads_or(open)) {    // the masks are complete
                done = true;
                break;
            }
            unsigned todo = sh.smask[sb];   // the chunks, in id order
            float next[ROWS];       // the triangle of the next chunk
            if (todo) load_tri(planes, seg + __ffs(todo) - 1, Tp, next);
            while (todo) {
                const int j = __ffs(todo) - 1;
                todo &= todo - 1;
                float tv[ROWS];
                for (int row = 0; row < ROWS; ++row) tv[row] = next[row];
                if (todo) load_tri(planes, seg + __ffs(todo) - 1, Tp, next);
                if (!(tv[9] > 0.5f)) continue;      // a padding slot
                const auto tri = [&tv](int p3, int k) {
                    return tv[p3 < 3 ? p3 * 3 + k : 9];
                };
                const int id = (seg + j) * CT + tid;
#pragma unroll
                for (int w = 0; w < WARPS; ++w) {
                    unsigned lanes = sh.cmask[sb][j][w];
                    while (lanes) {
                        const int l = w * 32 + __ffs(lanes) - 1;
                        lanes &= lanes - 1;
                        if (ANY && sh.occ[l]) continue;
                        const float4 a = sh.ro[l], b = sh.rd[l];
                        Ray q = {};
                        q.o[0] = a.x;
                        q.o[1] = a.y;
                        q.o[2] = a.z;
                        q.d[0] = b.x;
                        q.d[1] = b.y;
                        q.d[2] = b.z;
                        q.t_min = a.w;
                        const float t = mt_test(tri, q, b.w);
                        if (t < INF_T) {
                            if (ANY) {
                                if (atomicExch(&sh.occ[l], 1) == 0) {
                                    atomicAdd(&sh.n_occ, 1);
                                }
                            } else {
                                atomicMin(&sh.key[l],
                                          (static_cast<Key>(order_bits(t))
                                           << 32) |
                                              static_cast<unsigned>(id));
                            }
                        }
                    }
                }
            }
        }
    }
    __syncthreads();        // every hit is folded

    if (r < R) {
        if (ANY) {
            // the TPU any-hit contract: idx 1 or -1, t = t_max
            t_out[r] = ray.t_max;
            tri_out[r] = sh.occ[tid] ? 1 : -1;
        } else {
            const Key k = sh.key[tid];
            t_out[r] = k == ~0ull ? INF_T
                                  : from_order_bits(
                                        static_cast<unsigned>(k >> 32));
            tri_out[r] = k == ~0ull ? -1 : static_cast<int>(k & 0xffffffffu);
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
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = any_hit ? stream_kernel<true> : stream_kernel<false>;
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
