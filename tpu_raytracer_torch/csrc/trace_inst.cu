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
// same). Each lane keeps the minimum of the key (order bits of t << 32 |
// inst * Tp + object triangle): an exact-t tie goes to the earlier
// instance, then the earlier group, then the earlier slot, the
// reference's unit scan order, whatever order the kernel visits them in.
// The result is (t, object triangle g * 256 + slot, instance), or (INF,
// -1, -1).
//
// What bounds it: FP32 issue, not bytes. The gallery's object planes are
// 215 KB (5,376 slots) and stay in L2. Random rays are sparse: a live ray
// passes a third of an instance box on average (of 102), and a 128-ray
// block wants ~12.5 instances and ~38 of their 2,002 (instance, group)
// units. One thread a ray, sweeping every group its warp wants with a
// block barrier per instance and per group, issued ~24x the tests the
// lanes need, and the barriers cost more than the tests.
// What the design does about it, per 128-ray block (K3's scheme,
// trace_stream.cu, over two levels):
//   1. Instance units. A unit is GRP consecutive instances, GRP the
//      smallest power of two that keeps the units within MAX_UNITS
//      (single instances for the gallery's 102); thread u folds unit u's
//      box from its instances' world boxes, each padded as
//      mt.cuh:slab_window pads it. Each lane slab-tests each unit once
//      against (t_min, t_max), four units a step without a branch so
//      that their tests interleave; a ballot keeps a pass bit per unit
//      and lane, a warp minimum the block's entry into the unit, and the
//      lane its own furthest entry. One barrier for the pass.
//   2. Sort. Each unit's (entry, id) key is ranked against the others in
//      shared memory; units no lane reaches are dropped.
//   3. Exit, before each instance. A lane is done once it is occluded
//      (any-hit) or its best t lies strictly in front of the unit's
//      entry, a lower bound on any hit in this unit and every later one
//      (closest-hit), or once the unit's entry lies beyond its own
//      furthest entry (no unit it passed is left). The block leaves when
//      every lane is done, so the exit changes no result.
//   4. Per instance, in index order inside a unit: the lanes that pass
//      its box against their window so far are compacted (ballot and
//      popc), move their own ray into object space and write it to
//      shared memory. Their (lane, group) slab tests are spread over the
//      block and set, for each group, the mask of the lanes that want it,
//      32 groups a mask word. A group no lane wants is neither loaded nor
//      tested. Two block barriers a segment of 32 groups: none a group.
//   5. Tests. For each wanted group, thread j loads slots j and j + 128
//      from L2 into registers (a padded slot loads its validity and
//      nothing more) and tests them against every lane of the group's
//      mask, the ray read from shared memory as a broadcast.
//   6. Hits. Closest-hit folds the lane's key with a shared 64-bit
//      atomicMin; the test window stays (t_min, t_max), since a narrower
//      one would drop an equal-t hit of a lower instance id that comes
//      later in front-to-back order. Any-hit sets the lane's flag and
//      records the instance.

#include <cuda_runtime.h>

#include <cstdint>

#include "mt.cuh"

namespace {

using namespace tpurt;

constexpr int GROUP = 256;      // triangle slots per object group
constexpr int BLOCK = 128;      // rays per block
constexpr int WARPS = BLOCK / 32;
constexpr int SLOTS = GROUP / BLOCK;  // slots a thread holds in a group
constexpr int INST_COLS = 23;   // inst_table row width
constexpr unsigned FULL = 0xffffffffu;
// unit capacity; a smaller build-time value makes units of several
// instances (the g++ emulation's tests build 4)
#ifndef TPURT_INST_MAX_UNITS
#define TPURT_INST_MAX_UNITS 128
#endif
constexpr int MAX_UNITS = TPURT_INST_MAX_UNITS;
static_assert(MAX_UNITS <= BLOCK, "one thread folds and ranks each unit");
constexpr int SEG = 32;         // groups in one mask word
static_assert(SEG * WARPS == BLOCK, "a thread clears a word of gmask");
using Key = unsigned long long;

struct Shared {
    // an instance's object-space rays (o, t_min), (d, t_max), (1/d, -)
    // a lane, by the parity of the instance
    float4 oo[2][BLOCK], od[2][BLOCK], oi[2][BLOCK];
    Key key[BLOCK];                  // closest: (t bits << 32) | id a lane
    int occ[BLOCK];                  // any-hit: the lane is occluded
    int occ_inst[BLOCK];             // and by which instance
    float ubox[MAX_UNITS][6];        // the units' padded boxes
    unsigned uentry[MAX_UNITS];      // order bits of the block's entry
    Key ukey[MAX_UNITS];             // (entry bits << 32) | unit, sorted
    unsigned ubits[MAX_UNITS][WARPS];  // a lane passed the unit's box
    int list[BLOCK];                 // an instance's lanes, 32 a warp
    int cnt[2][WARPS];               // and their count a warp, by parity
    unsigned smask[2];               // a segment's groups some lane wants
    unsigned gmask[2][SEG][WARPS];   // the lanes that want each group
};

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

// The slab entry of the lane's window into an already padded unit box
// [6] (min xyz, max xyz), else INF_T: trace_stream.cu:box_entry without
// its early return, so that several of them interleave.
__device__ __forceinline__ float unit_entry(const float* box,
                                            const Ray& ray) {
    float t_lo = ray.t_min, t_hi = ray.t_max;
    for (int k = 0; k < 3; ++k) {
        const float a = (box[k] - ray.o[k]) * ray.inv[k];
        const float b = (box[3 + k] - ray.o[k]) * ray.inv[k];
        t_lo = fmaxf(t_lo, fminf(a, b));
        t_hi = fminf(t_hi, fmaxf(a, b));
    }
    return box[0] <= box[3] && t_lo <= t_hi ? t_lo : INF_T;
}

// Group g's slots held by this thread against the lanes of its mask:
// object rays in buffer b, lane masks in gmask[mb][j].
template <bool ANY>
__device__ __forceinline__ void test_group(Shared& sh,
                                           const float* __restrict__ planes,
                                           int Tp, int g, int inst, int b,
                                           int mb, int j) {
    float tv[SLOTS][9];
    bool valid[SLOTS];
    bool any = false;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
        const int slot = g * GROUP + s * BLOCK + threadIdx.x;
        valid[s] = __ldg(planes + 9 * Tp + slot) > 0.5f;
        any = any || valid[s];
        if (valid[s]) {
            for (int row = 0; row < 9; ++row) {
                tv[s][row] = __ldg(planes + row * Tp + slot);
            }
        }
    }
    if (!any) return;       // padding slots only
    const unsigned id0 = static_cast<unsigned>(inst) *
                             static_cast<unsigned>(Tp) +
                         static_cast<unsigned>(g * GROUP + threadIdx.x);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        unsigned lanes = sh.gmask[mb][j][w];
        while (lanes) {
            const int l = w * 32 + __ffs(lanes) - 1;
            lanes &= lanes - 1;
            if (ANY && sh.occ[l]) continue;
            const float4 a = sh.oo[b][l], c = sh.od[b][l];
            Ray q = {};
            q.o[0] = a.x;
            q.o[1] = a.y;
            q.o[2] = a.z;
            q.d[0] = c.x;
            q.d[1] = c.y;
            q.d[2] = c.z;
            q.t_min = a.w;
            float t_hit = INF_T;
            int s_hit = 0;
#pragma unroll
            for (int s = 0; s < SLOTS; ++s) {
                if (!valid[s]) continue;
                const auto tri = [&tv, s](int p, int k) {
                    return p < 3 ? tv[s][p * 3 + k] : 1.0f;
                };
                const float t = mt_test(tri, q, c.w);
                if (t < t_hit) {        // strict: the lower slot on a tie
                    t_hit = t;
                    s_hit = s;
                }
            }
            if (t_hit < INF_T) {
                if (ANY) {
                    if (atomicExch(&sh.occ[l], 1) == 0) sh.occ_inst[l] = inst;
                } else {
                    const Key k = (static_cast<Key>(order_bits(t_hit)) << 32) |
                                  (id0 + static_cast<unsigned>(s_hit * BLOCK));
                    if (k < sh.key[l]) atomicMin(&sh.key[l], k);
                }
            }
        }
    }
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
inst_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_min, const float* __restrict__ t_max,
            const float* __restrict__ planes, const float* __restrict__ gaabb,
            const float* __restrict__ inst_table,
            const float* __restrict__ inst_aabb,
            const int32_t* __restrict__ span, int R, int I, int NGO,
            int grp, int n_units, float* __restrict__ t_out,
            int32_t* __restrict__ tri_out, int32_t* __restrict__ inst_out) {
    __shared__ __align__(128) Shared sh;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;   // lanes before this one
    const int r = blockIdx.x * BLOCK + tid;
    const int Tp = NGO * GROUP;
    const Ray ray = load_ray(o, d, t_min, t_max, min(r, R - 1), R);
    const bool live = r < R && ray.t_max > 0.0f;
    sh.key[tid] = ~0ull;
    sh.occ[tid] = 0;
    sh.occ_inst[tid] = -1;

    // 1. unit boxes from the padded instance boxes, as slab_window pads
    if (tid < n_units) {
        float box[6] = {INF_T, INF_T, INF_T, -INF_T, -INF_T, -INF_T};
        for (int i = tid * grp; i < min((tid + 1) * grp, I); ++i) {
            const float* bx = inst_aabb + i * 8;
            if (!(__ldg(bx) <= __ldg(bx + 3))) continue;    // an empty box
            for (int k = 0; k < 3; ++k) {
                const float lo = __ldg(bx + k), hi = __ldg(bx + 3 + k);
                const float pad = 1e-5f * (fabsf(lo) + fabsf(hi)) + 1e-6f;
                box[k] = fminf(box[k], lo - pad);
                box[3 + k] = fmaxf(box[3 + k], hi + pad);
            }
        }
        for (int k = 0; k < 6; ++k) sh.ubox[tid][k] = box[k];
        sh.uentry[tid] = order_bits(INF_T);
    }
    __syncthreads();

    // each lane's pass bit of each unit box, the block's entry into it,
    // and the lane's furthest entry, four units a step
    float reach = -INF_T;
    for (int u0 = 0; u0 < n_units; u0 += 4) {
        float e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            e[k] = unit_entry(sh.ubox[min(u0 + k, n_units - 1)], ray);
            e[k] = live ? e[k] : INF_T;
        }
#pragma unroll
        for (int k = 0; k < 4 && u0 + k < n_units; ++k) {
            if (e[k] < INF_T) reach = fmaxf(reach, e[k]);
            const unsigned bits = __ballot_sync(FULL, e[k] < INF_T);
            const unsigned first = __reduce_min_sync(FULL, order_bits(e[k]));
            if (lane == 0) {
                sh.ubits[u0 + k][warp] = bits;
                atomicMin(&sh.uentry[u0 + k], first);
            }
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
    const int n_live = __syncthreads_count(     // units some lane reaches
        tid < n_units && sh.uentry[tid] < order_bits(INF_T));

    // 3. front to back, unit by unit, each unit's instances in id order
    int ip = 0;             // parity of the instance buffers
    int sp = 0;             // parity of the mask buffers
    bool done = false;
    for (int p = 0; p < n_live && !done; ++p) {
        const Key uk = sh.ukey[p];
        const int u = static_cast<int>(uk & 0xffffffffu);
        const float entry = from_order_bits(static_cast<unsigned>(uk >> 32));
        const bool in_unit = live && ((sh.ubits[u][warp] >> lane) & 1u);
        for (int i = u * grp; i < min((u + 1) * grp, I); ++i) {
            const int b = ip, mb = sp;
            ip ^= 1;
            sp ^= 1;
            const Key kb = sh.key[tid];
            const float t_best =
                kb == ~0ull ? INF_T
                            : from_order_bits(static_cast<unsigned>(kb >> 32));
            // a flag or key set since the last barrier may not show yet:
            // the lane then stays open, which changes no result
            const bool lane_done = ANY ? sh.occ[tid] != 0 : t_best < entry;
            const bool open = live && !(reach < entry) && !lane_done;
            // 4. the lanes that pass the instance's box, compacted, with
            // their rays in object space
            const bool in =
                in_unit && !lane_done &&
                slab_pass(inst_aabb + i * 8, 1, ray, ray.t_min,
                          ANY ? ray.t_max : fminf(ray.t_max, t_best));
            const unsigned ins = __ballot_sync(FULL, in);
            if (in) {
                sh.list[warp * 32 + __popc(ins & below)] = tid;
                const Ray obj = to_object(inst_table + i * INST_COLS, ray);
                sh.oo[b][tid] = make_float4(obj.o[0], obj.o[1], obj.o[2],
                                            ray.t_min);
                sh.od[b][tid] = make_float4(obj.d[0], obj.d[1], obj.d[2],
                                            ray.t_max);
                sh.oi[b][tid] = make_float4(obj.inv[0], obj.inv[1],
                                            obj.inv[2], 0.0f);
            }
            if (lane == 0) sh.cnt[b][warp] = __popc(ins);
            (&sh.gmask[mb][0][0])[tid] = 0;
            if (tid == 0) sh.smask[mb] = 0;
            // the exit; the list, the rays and the last hits folded
            if (!__syncthreads_or(open)) {
                done = true;
                break;
            }
            // where each warp's lanes start in the compacted order
            const int o1 = sh.cnt[b][0], o2 = o1 + sh.cnt[b][1],
                      o3 = o2 + sh.cnt[b][2];
            const int n_in = o3 + sh.cnt[b][3];
            if (n_in == 0) continue;
            const int g0 = __ldg(span + i), ng = __ldg(span + I + i);
            for (int seg = 0; seg < ng; seg += SEG) {
                int sb = mb;
                if (seg > 0) {      // the next 32 groups: fresh masks
                    sb = sp;
                    sp ^= 1;
                    (&sh.gmask[sb][0][0])[tid] = 0;
                    if (tid == 0) sh.smask[sb] = 0;
                    __syncthreads();
                }
                const int n = min(SEG, ng - seg);
                // each (listed lane, group) pair's slab test against the
                // lane's window so far, spread over the block
                const int pairs = n_in * n;
                for (int base = 0; base < pairs; base += BLOCK) {
                    const int x = base + tid;
                    unsigned bit = 0;
                    if (x < pairs) {
                        const int k = x / n, j = x - k * n;
                        const int w = (k >= o1) + (k >= o2) + (k >= o3);
                        const int first = w == 0 ? 0 : w == 1 ? o1
                                          : w == 2 ? o2 : o3;
                        const int l = sh.list[w * 32 + k - first];
                        const float4 a = sh.oo[b][l], v = sh.oi[b][l];
                        float hi = sh.od[b][l].w;
                        bool want = true;
                        if (ANY) {
                            want = !sh.occ[l];
                        } else if (sh.key[l] != ~0ull) {
                            hi = fminf(hi, from_order_bits(static_cast<
                                               unsigned>(sh.key[l] >> 32)));
                        }
                        Ray q = {};
                        q.o[0] = a.x;
                        q.o[1] = a.y;
                        q.o[2] = a.z;
                        q.inv[0] = v.x;
                        q.inv[1] = v.y;
                        q.inv[2] = v.z;
                        if (want && slab_pass(gaabb + g0 + seg + j, NGO, q,
                                              a.w, hi)) {
                            bit = 1u << j;
                            atomicOr(&sh.gmask[sb][j][l >> 5],
                                     1u << (l & 31));
                        }
                    }
                    const unsigned wm = __reduce_or_sync(FULL, bit);
                    if (lane == 0 && wm) atomicOr(&sh.smask[sb], wm);
                }
                __syncthreads();    // the masks are complete
                // 5. the tests, group by wanted group
                for (unsigned todo = sh.smask[sb]; todo; todo &= todo - 1) {
                    const int j = __ffs(todo) - 1;
                    test_group<ANY>(sh, planes, Tp, g0 + seg + j, i, b, sb,
                                    j);
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
            inst_out[r] = sh.occ_inst[tid];
        } else {
            const Key k = sh.key[tid];
            const unsigned id = static_cast<unsigned>(k & 0xffffffffu);
            const bool hit = k != ~0ull;
            t_out[r] = hit ? from_order_bits(static_cast<unsigned>(k >> 32))
                           : INF_T;
            tri_out[r] = hit ? static_cast<int>(id % Tp) : -1;
            inst_out[r] = hit ? static_cast<int>(id / Tp) : -1;
        }
    }
}

int launch(bool any_hit, const void* o, const void* d, const void* t_min,
           const void* t_max, const void* planes, const void* gaabb,
           const void* inst_table, const void* inst_aabb, const void* span,
           int R, int I, int NGO, void* t_out, void* tri_out, void* inst_out,
           void* stream) {
    if (R > 0) {
        int grp = 1;
        while ((I + grp - 1) / grp > MAX_UNITS) grp <<= 1;
        const int n_units = (I + grp - 1) / grp;
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        auto kernel = any_hit ? inst_kernel<true> : inst_kernel<false>;
        kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const float*>(planes),
            static_cast<const float*>(gaabb),
            static_cast<const float*>(inst_table),
            static_cast<const float*>(inst_aabb),
            static_cast<const int32_t*>(span), R, I, NGO, grp, n_units,
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
// span [2, I] i32 (first group, group count) inside [0, NGO); I * NGO *
// 256 < 2^32. Outputs t [R] f32, tri [R] i32 (object triangle), inst [R]
// i32. Returns cudaGetLastError() after the launch.
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
