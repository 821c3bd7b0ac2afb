// The front-to-back per-lane sweep of a flattened triangle table, shared
// by kernels K1/K2 (trace.cu: tables of up to MXUF_MAX_TP slots) and K3
// (trace_stream.cu: the tables past it). One copy; each kernel is an
// instance of `sweep` with its own unit capacity.
//
// Semantics are those of the exact-f32 scan `_trace_brute_xla` and of the
// plain versions (ops/trace_api.py:trace_plain, ops/trace_stream.py:
// trace_stream_plain), exactly: the Moller-Trumbore test of mt.cuh, and
// for each lane the lexicographic minimum of (t, triangle id), so an
// exact-t tie goes to the lowest id whatever the sweep order. Any-hit
// returns the TPU any-hit kernels' contract: tri 1 / -1 and t = t_max.
//
// What bounds it on this card: instruction issue (the exact tests, the
// slab tests that pick them, and the block's fixed cost per step), not
// HBM: a table is at most 100,864 slots x 40 B (the knot's 4.03 MB of
// rows read) and stays in the 50 MB L2. Incoherent rays want few chunks
// each, but a block of 128 such rays wants most of them, so a sweep with
// one thread a ray runs every lane through the union of its warp's
// chunks, a worklist that slab-tests every chunk box against every lane
// costs as much as the tests, and a block barrier per chunk costs more
// than the chunk's few tests.
// What the design does about it, per 128-ray block:
//   1. Unit boxes. A unit is grp consecutive chunks, grp the smallest
//      power of two that keeps the units within MAX_UNITS. Thread u folds
//      unit u's box from its chunks' boxes, each padded as
//      mt.cuh:slab_window pads it, so the unit box holds every padded
//      chunk box and its (unpadded) slab entry is a lower bound on any hit
//      in the unit; at grp 1 it is the chunk's padded box itself. Each
//      lane slab-tests each unit once; a ballot keeps a pass bit per unit
//      and lane, and a warp minimum the block's entry into each unit.
//   2. Sort. Each unit's (entry, id) key is ranked against the others in
//      shared memory; units no lane reaches rank last and are dropped.
//   3. Segments. Units go front to back, in segments of up to 32 chunks.
//      The lanes that passed the unit's box are compacted into a list
//      (ballot and popc per warp), and the (lane, chunk) slab tests against
//      each lane's window so far are spread over the block: they set, for
//      each chunk, the bit mask of the lanes that want it. A chunk no lane
//      wants is not loaded. Two block barriers a segment: none a chunk.
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
//      H100 (PERF.md §6, PR 6), and was dropped.
//
// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane); planes [4, 3, Tp] with Tp a multiple of 128; aabb
// [Tp/128, 8]. Outputs t [R] f32 and tri [R] i32.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

namespace tpurt {

constexpr int SWEEP_BLOCK = 128;  // rays per block = triangles per chunk

namespace sweep_detail {

constexpr int CT = SWEEP_BLOCK;   // thread j tests triangle j of a chunk
constexpr int WARPS = SWEEP_BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SEG = 32;           // chunks in one mask word
static_assert(SEG * WARPS == SWEEP_BLOCK, "a thread clears a word of cmask");
constexpr int ROWS = 10;          // float rows of a chunk: v0, e1, e2, valid
using Key = unsigned long long;

template <int MAX_UNITS>
struct Shared {
    float4 ro[SWEEP_BLOCK];          // the lanes' (o, t_min)
    float4 rd[SWEEP_BLOCK];          // (d, t_max)
    float4 ri[SWEEP_BLOCK];          // (1/d, unused)
    Key key[SWEEP_BLOCK];            // closest: (t bits << 32) | id a lane
    int occ[SWEEP_BLOCK];            // any-hit: the lane is occluded
    int n_occ;                       // any-hit: occluded lanes
    float ubox[MAX_UNITS][6];        // the units' padded boxes
    unsigned uentry[MAX_UNITS];      // order bits of the block's entry
    Key ukey[MAX_UNITS];             // (entry bits << 32) | unit, sorted
    unsigned ubits[MAX_UNITS][WARPS];  // a lane passed the unit's box
    int list[SWEEP_BLOCK];           // a segment's lanes, 32 slots a warp
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

}  // namespace sweep_detail

// (grp, units) of a table of nc chunks under a capacity of max_units units:
// grp is the smallest power of two that keeps the units within it.
inline void sweep_units(int nc, int max_units, int& grp, int& n_units) {
    grp = 1;
    while ((nc + grp - 1) / grp > max_units) grp <<= 1;
    n_units = (nc + grp - 1) / grp;
}

// The sweep of one 128-ray block (blockIdx.x) over units of grp chunks
// (n_units of them; see sweep_units). Call it from a kernel of
// SWEEP_BLOCK threads.
template <bool ANY, int MAX_UNITS>
__device__ __forceinline__ void sweep(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const float* __restrict__ planes, const float* __restrict__ aabb, int R,
    int Tp, int grp, int n_units, float* __restrict__ t_out,
    int32_t* __restrict__ tri_out) {
    using namespace sweep_detail;
    static_assert(MAX_UNITS <= SWEEP_BLOCK,
                  "one thread folds and ranks each unit");
    __shared__ __align__(128) Shared<MAX_UNITS> sh;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;   // lanes before this one
    const int r = blockIdx.x * SWEEP_BLOCK + tid;
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
            for (int base = 0; base < pairs; base += SWEEP_BLOCK) {
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

}  // namespace tpurt
