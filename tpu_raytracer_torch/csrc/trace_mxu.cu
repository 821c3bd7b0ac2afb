// Feature-matmul traversal kernels of the PyTorch port, for Hopper
// (sm_90a): the ray-triangle test on the tensor cores.
//
//   K6  tpurt_mxu_closest_hit / tpurt_mxu_any_hit  replace
//       tpu_raytracer/ops/pallas_trace.py
//         #7 `_mt_kernel_mxu` (:1186)   modes mxu3 / mxu1: units of one
//            chunk, 3 or 1 bf16 passes;
//         #6 `_mt_kernel_mxuw` (:1070)  mode mxuw[N]: units of N chunks
//            (here the hulls of step 1), 3 passes;
//         #5 `_mt_kernel_mxui` (:701)   mxuf* under the in-kernel cull:
//            groups of 2 or 4 chunks slab-tested in the kernel by their
//            union box, closest- and any-hit;
//       and the feeders of #6 and #7: the XLA prepass `_block_entry`
//       (:1326) and its entry sort (:1623-1628).
//
// det, u*det, v*det and t*det of a ray and a triangle are linear in the
// ray's 16 features phi = [o_i d_j (9), d (3), o (3), 1]
// (`mt_coef_device`, :251-307). Each lane splits its phi into bf16 hi and
// lo halves; a warp multiplies a tile of 16 triangles' coefficients (the
// reference's `mt_coef48`, laid out by ops/trace_mxu.py:kernel_table in
// mma.sync's A-fragment order) by 8 rays' halves with mma.sync m16n8k16
// (mma.cuh), one product a quantity [det | u | v | t], so each thread's
// accumulators hold all four numerators of the same 4 (triangle, ray)
// pairs. The window test is the reference's (:1231-1249: sign fold,
// |det| > 1e-9, t = (t_n sgn) / |det| by IEEE division under
// -fmad=false; any-hit division-free, :758-765), and each lane keeps (t,
// id) lexicographically, so an exact-t tie goes to the lowest id. #6's
// block-diagonal mask (`_mxuw_mask`, :333-340) exists because a K = 16
// dot costs the TPU's matrix unit as much as K = 128; here a unit's
// chunks are more tiles of the same K = 16 product.
//
// Which pairs are tested: a live lane tests chunk c when its window
// (t_min, t_max) passes c's padded box (mt.cuh:slab_pass; mxu3, mxu1,
// mxuw[N]), or the padded union box of c's group of grp chunks (the
// in-kernel cull). The plain version (ops/trace_mxu.py:trace_mxu_plain
// over lane_chunks) tests the same pairs. mxuw[N]'s units of N chunks
// are hulls the lanes test first; they change which box tests run, not
// which pairs.
//
// Numerics: the products of bf16 halves are exact; the tensor cores do
// not round each f32 addition to nearest, so t differs from the plain
// version (f64 sum, one rounding) by ulps and a winner may flip on a
// knife-edge ray. Held to the reference's tolerance, not bit for bit.
//
// What bounds it on this card: instruction issue and the latency of the
// coefficient loads, not the products. A pair's window test takes ~12
// FP32 and predicate instructions against 2 x 16 x 4 x passes FLOP on the
// tensor cores, and a chunk's coefficients are 32 KB (256 B a triangle),
// read from L2 for each block that wants the chunk. The first design ran
// every lane of a 128-ray block through every unit any one of its lanes
// wanted (about 11 chunks x 128 tests a random Cornell ray, whose window
// passes ~1.5 chunk boxes), computed the division before the test that
// rejects nearly every pair, and read its units from an eager worklist
// prepass that cost more than the kernel.
// What the design does about it, per 128-ray block:
//   1. Units in the kernel. Each lane tests its window against each unit
//      (a chunk's box, or the cull's group box); a ballot keeps a pass
//      bit per unit and lane. Hulls of N chunks (mxuw[N]), or of as many
//      as keep them within 32, come first (the hull of the chunks'
//      padded boxes), so a warp skips the tests of the chunks none of its
//      lanes can reach. No prepass.
//   2. Tests follow the lanes. Per unit, the lanes that passed it are
//      compacted (ballot and popc) into 8-ray column tiles, the finest
//      the product takes; every warp tests every tile against its quarter
//      of each chunk's triangles (2 tiles of 16), loading their
//      coefficients once, so the four warps share each chunk's work and
//      its loads.
//   3. Division only where it can matter: the sign fold, |det| and the
//      barycentric test first, the IEEE division only for a pair inside
//      the triangle, then the same comparisons as before, so the answers
//      are those of the division-first form bit for bit.
//   4. Coefficients straight from L2 into registers (two 16-byte words a
//      thread and quantity), no shared memory and no barrier. Two designs
//      were measured against it and dropped, slower on every ray set
//      (PERF.md §6): each wanted chunk's 32 KB staged once per block by a
//      bulk copy on an mbarrier, double-buffered, read by all warps from
//      shared memory; and wgmma m64n128k16 on such staged tiles, 64 lanes
//      a product.
//   5. Hits. A hit is folded into its lane at once: closest-hit (order
//      bits of t << 32 | id) by a shared 64-bit atomicMin, so no order of
//      tiles or atomics changes the answer; any-hit sets the lane's flag,
//      an occluded lane drops out of later units, and the block leaves
//      once every lane that passed some unit is occluded.
//   6. No closest-hit exit and no window narrowed to the best t. Both are
//      exact in K1 because K1's t is exact; K6's t is not: a bf16 split
//      keeps ~16 bits of each coefficient and feature, so where t_n or
//      det cancels (a ray far from the origin near a triangle, a grazing
//      ray) the 3-pass t can err by more than the boxes' padding (1e-5 of
//      the coordinates plus 1e-6), and at 1 pass by about 2^-9. A box
//      entered after a lane's best t may then still hold its winner, so
//      every lane keeps its (t_min, t_max) window over every unit it
//      passes.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "mt.cuh"
#include "sweep.cuh"

namespace {

using namespace tpurt;

constexpr int CT = 128;            // triangles per chunk
constexpr int BLOCK = 128;         // rays per block: 4 warps of 32
constexpr int WARPS = BLOCK / 32;
constexpr int TT = CT / 16;        // 16-triangle row tiles per chunk
constexpr int PAD_ROW = BLOCK;     // the row of a tile past the lane list
constexpr int CHUNK_VEC = TT * 4 * 32 * 2;  // 16-byte words of a chunk
// the routes' largest tables (ops/trace_api.py: MXU_MAX_TP, MXUW_MAX_TP)
// and the in-kernel cull's (INCULL_MAX_CHUNKS in groups of 2)
constexpr int MAX_UNITS = 384;
constexpr int MAX_GROUPS = 32;
constexpr unsigned FULL = 0xffffffffu;
using Key = unsigned long long;

struct Shared {
    uint32_t f[BLOCK + 1][17];     // phi's halves a lane: hi words 0-7, lo
                                   // 8-15 (+1 pad); row PAD_ROW is zero
    float lo[BLOCK + 1];           // the lanes' windows; PAD_ROW's is empty
    float hi[BLOCK + 1];
    Key key[BLOCK];                // closest: (t bits << 32) | id a lane
    int occ[BLOCK];                // any-hit: the lane is occluded
    int n_occ;                     // any-hit: occluded lanes
    float gbox[MAX_GROUPS][6];     // the cull's groups or the units' hulls
    unsigned ubits[MAX_UNITS][WARPS];  // a lane passed the unit
    int list[BLOCK];               // the unit's lanes, compacted
    int cnt[WARPS];                // and their count a warp
};

// mt.cuh:slab_pass's arithmetic on an unpadded box [6] in shared memory:
// the box padded by 1e-5 of its coordinates' magnitude plus 1e-6, then
// the window (t_lo, t_hi) clipped to its slabs; false for an empty box.
__device__ __forceinline__ bool group_pass(const float* box, const Ray& ray,
                                           float t_lo, float t_hi) {
    if (!(box[0] <= box[3])) return false;
    for (int k = 0; k < 3; ++k) {
        const float lo = box[k], hi = box[3 + k];
        const float pad = 1e-5f * (fabsf(lo) + fabsf(hi)) + 1e-6f;
        const float a = (lo - pad - ray.o[k]) * ray.inv[k];
        const float b = (hi + pad - ray.o[k]) * ray.inv[k];
        t_lo = fmaxf(t_lo, fminf(a, b));
        t_hi = fminf(t_hi, fmaxf(a, b));
    }
    return t_lo <= t_hi;
}

// The reference's window test of the pair (lane l with window (lo, hi),
// triangle id) on its four products; a hit is folded into the lane at
// once: closest-hit (order bits of t << 32 | id) by a shared atomicMin, so
// no order of tests or atomics changes the answer; any-hit the lane's
// flag. The division comes after the barycentric test: for a pair inside
// the triangle |det| > 1e-9, so t = (t_n sgn) / |det| is the
// division-first form's (t_n sgn) / (ok ? |det| : 1) bit for bit.
template <bool ANY>
__device__ __forceinline__ void window_test(Shared& sh, int l, float lo,
                                            float hi, float det, float u_n,
                                            float v_n, float t_n, int id) {
    const float sgn = det >= 0.0f ? 1.0f : -1.0f;
    const float d_abs = det * sgn;
    const float u2 = u_n * sgn;
    const float v2 = v_n * sgn;
    if (!(d_abs > MT_EPS && u2 >= 0.0f && v2 >= 0.0f && u2 + v2 <= d_abs &&
          hi > 0.0f)) {
        return;
    }
    if (ANY) {
        const float tn2 = t_n * sgn;
        if (tn2 > lo * d_abs && tn2 < hi * d_abs &&
            atomicExch(&sh.occ[l], 1) == 0) {
            atomicAdd(&sh.n_occ, 1);
        }
    } else {
        const float t = (t_n * sgn) / d_abs;
        if (t > lo && t < hi) {
            atomicMin(&sh.key[l], (static_cast<Key>(order_bits(t)) << 32) |
                                      static_cast<unsigned>(id));
        }
    }
}

template <int PASSES, bool INCULL, bool ANY>
__global__ void __launch_bounds__(BLOCK)
mxu_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const uint4* __restrict__ table, const float* __restrict__ aabb,
           int R, int nc, int grp, float* __restrict__ t_out,
           int32_t* __restrict__ tri_out) {
    __shared__ __align__(16) Shared sh;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
    const unsigned below = (1u << lane) - 1u;
    const int r = blockIdx.x * BLOCK + tid;
    // a unit: the cull's group of grp chunks, else one chunk
    const int usz = INCULL ? grp : 1;
    const int n_units = (nc + usz - 1) / usz;
    Ray ray = {};
    if (r < R) ray = load_ray(o, d, t_min, t_max, r, R);
    const bool live = r < R && ray.t_max > 0.0f;

    // 1. this lane's phi, split into bf16 halves, and its window
    {
        const float ox = ray.o[0], oy = ray.o[1], oz = ray.o[2];
        const float dx = ray.d[0], dy = ray.d[1], dz = ray.d[2];
        const float phi[16] = {ox * dx, ox * dy, ox * dz, oy * dx, oy * dy,
                               oy * dz, oz * dx, oz * dy, oz * dz, dx, dy,
                               dz, ox, oy, oz, 1.0f};
        for (int w = 0; w < 8; ++w) {
            uint32_t h0, l0, h1, l1;
            split_bf16(phi[2 * w], h0, l0);
            split_bf16(phi[2 * w + 1], h1, l1);
            sh.f[tid][w] = h0 | (h1 << 16);
            sh.f[tid][8 + w] = l0 | (l1 << 16);
        }
    }
    sh.lo[tid] = ray.t_min;
    sh.hi[tid] = ray.t_max;
    sh.key[tid] = ~0ull;
    sh.occ[tid] = 0;
    if (tid < 16) sh.f[PAD_ROW][tid] = 0u;
    if (tid == 0) {
        sh.lo[PAD_ROW] = sh.hi[PAD_ROW] = 0.0f;
        sh.n_occ = 0;
    }
    // hulls of `span` consecutive chunks (mxuw[N]: at least N), at most
    // MAX_GROUPS of them (span 1: none), so that a warp skips the box
    // tests of the chunks no lane can reach; the in-kernel cull's groups
    // are at most MAX_GROUPS and take no hulls
    int span = INCULL ? 1 : grp;
    while ((n_units + span - 1) / span > MAX_GROUPS) span <<= 1;
    const bool hulls = span > 1;
    const int n_hulls = (n_units + span - 1) / span;
    if (tid < n_hulls && (INCULL || hulls)) {
        // the cull: the group's union box, unpadded; else the hull of the
        // chunks' padded boxes, as mt.cuh:slab_window pads them, so that
        // a window that passes a chunk's box passes its hull
        float box[6] = {INF_T, INF_T, INF_T, -INF_T, -INF_T, -INF_T};
        const int c1 = min((tid + 1) * span * usz, nc);
        for (int c = tid * span * usz; c < c1; ++c) {
            const float* b = aabb + c * 8;
            if (!INCULL && !(__ldg(b) <= __ldg(b + 3))) continue;  // empty
            for (int k = 0; k < 3; ++k) {
                const float lo = __ldg(b + k), hi = __ldg(b + 3 + k);
                const float pad =
                    INCULL ? 0.0f : 1e-5f * (fabsf(lo) + fabsf(hi)) + 1e-6f;
                box[k] = fminf(box[k], INCULL ? lo : lo - pad);
                box[3 + k] = fmaxf(box[3 + k], INCULL ? hi : hi + pad);
            }
        }
        for (int k = 0; k < 6; ++k) sh.gbox[tid][k] = box[k];
    }
    __syncthreads();

    // 2. each lane's pass bit of each unit
    bool wants = false;
    for (int hull = 0; hull < n_hulls; ++hull) {
        const bool near = !hulls || (live && sweep_detail::box_entry(
                                                 sh.gbox[hull], ray,
                                                 ray.t_min, ray.t_max) <
                                                 INF_T);
        const bool warp_near = !hulls || __ballot_sync(FULL, near) != 0u;
        for (int u = hull * span; u < min((hull + 1) * span, n_units); ++u) {
            bool pass = false;
            if (live && near) {
                pass = INCULL ? group_pass(sh.gbox[u], ray, ray.t_min,
                                           ray.t_max)
                              : slab_pass(aabb + u * 8, 1, ray, ray.t_min,
                                          ray.t_max);
            }
            wants = wants || pass;
            const unsigned bits = warp_near ? __ballot_sync(FULL, pass) : 0u;
            if (lane == 0) sh.ubits[u][warp] = bits;
        }
    }
    // lanes that can be occluded; the pass bits are complete
    const int n_wants = __syncthreads_count(wants);

    // 3. the units some lane passed, in id order
    for (int u = 0; u < n_units; ++u) {
        if ((sh.ubits[u][0] | sh.ubits[u][1] | sh.ubits[u][2] |
             sh.ubits[u][3]) == 0u) {
            continue;
        }
        // the lanes that passed the unit (any-hit: an occluded lane drops
        // out; a flag set since the last barrier may not show yet, which
        // costs tests, not answers), compacted
        const bool in = ((sh.ubits[u][warp] >> lane) & 1u) &&
                        !(ANY && sh.occ[tid]);
        const unsigned ins = __ballot_sync(FULL, in);
        if (lane == 0) sh.cnt[warp] = __popc(ins);
        __syncthreads();       // the counts; the last unit's hits folded
        if (ANY && sh.n_occ == n_wants) break;
        int off = 0, n = 0;
        for (int w = 0; w < WARPS; ++w) {
            off += w < warp ? sh.cnt[w] : 0;
            n += sh.cnt[w];
        }
        if (in) sh.list[off + __popc(ins & below)] = tid;
        __syncthreads();       // the list
        const int c1 = min((u + 1) * usz, nc);
        for (int c = u * usz; c < c1; ++c) {
            const uint4* tab = table + c * CHUNK_VEC;
            // rays as the product's columns: this warp's 2 tiles of 16
            // triangles (A: their coefficients, loaded once) against every
            // 8-ray tile of the list (B: the rays' features)
            for (int tt = warp * (TT / WARPS); tt < (warp + 1) * (TT / WARPS);
                 ++tt) {
                uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
                for (int qd = 0; qd < 4; ++qd) {
                    const uint4 w0 = tab[((tt * 4 + qd) * 32 + lane) * 2];
                    const uint4 w1 = tab[((tt * 4 + qd) * 32 + lane) * 2 + 1];
                    a_hi[qd][0] = w0.x;
                    a_hi[qd][1] = w0.y;
                    a_hi[qd][2] = w0.z;
                    a_hi[qd][3] = w0.w;
                    a_lo[qd][0] = w1.x;
                    a_lo[qd][1] = w1.y;
                    a_lo[qd][2] = w1.z;
                    a_lo[qd][3] = w1.w;
                }
                for (int p0 = 0; p0 < n; p0 += 8) {
                    // column g: ray p0 + g's features; this thread's
                    // accumulators: rays p0 + 2q and p0 + 2q + 1
                    const int lg = p0 + g < n ? sh.list[p0 + g] : PAD_ROW;
                    uint32_t b_hi[1][2] = {{sh.f[lg][q], sh.f[lg][q + 4]}};
                    uint32_t b_lo[1][2] = {{sh.f[lg][8 + q],
                                            sh.f[lg][12 + q]}};
                    int l[2];
                    float lo[2], hi[2];
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int p = p0 + 2 * q + j;
                        l[j] = p < n ? sh.list[p] : PAD_ROW;
                        lo[j] = sh.lo[l[j]];
                        hi[j] = sh.hi[l[j]];
                    }
                    float acc[4][1][4];
                    mma_split<PASSES, 4, 1>(acc, a_hi, a_lo, b_hi, b_lo);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int j = e & 1;
                        window_test<ANY>(sh, l[j], lo[j], hi[j], acc[0][0][e],
                                         acc[1][0][e], acc[2][0][e],
                                         acc[3][0][e],
                                         c * CT + tt * 16 + g + 8 * (e >> 1));
                    }
                }
            }
        }
    }
    __syncthreads();           // every hit is folded

    if (r < R) {
        if (ANY) {
            // the TPU any-hit contract: idx 1 or -1, t = t_max
            t_out[r] = ray.t_max;
            tri_out[r] = sh.occ[tid] ? 1 : -1;
        } else {
            const Key key = sh.key[tid];
            t_out[r] = key == ~0ull ? INF_T
                                    : from_order_bits(
                                          static_cast<unsigned>(key >> 32));
            tri_out[r] = key == ~0ull ? -1
                                      : static_cast<int>(key & 0xffffffffu);
        }
    }
}

template <int PASSES, bool INCULL, bool ANY>
int launch(const void* o, const void* d, const void* t_min,
           const void* t_max, const void* table, const void* aabb, int R,
           int nc, int grp, void* t_out, void* tri_out, void* stream) {
    const dim3 grid((R + BLOCK - 1) / BLOCK);
    const auto kernel = mxu_kernel<PASSES, INCULL, ANY>;
    kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const uint4*>(table), static_cast<const float*>(aabb),
            R, nc, grp, static_cast<float*>(t_out),
            static_cast<int32_t*>(tri_out));
    return static_cast<int>(cudaGetLastError());
}

// The tables a launch may take: MAX_UNITS chunks, or MAX_GROUPS groups.
bool units_fit(int nc, int grp, bool incull) {
    return grp >= 1 && (incull ? (nc + grp - 1) / grp <= MAX_GROUPS
                               : nc <= MAX_UNITS);
}

}  // namespace

extern "C" {

// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane); table [nc, 8, 4, 32, 16] bf16 (ops/trace_mxu.py:
// kernel_table); aabb [nc, 8], the chunk boxes. With incull a lane tests
// the groups of grp chunks whose union box it passes, else the chunks
// whose boxes it passes, hulls of at least grp chunks first. passes: 3, or
// 1 without incull. Outputs t [R] f32 and tri [R] i32 (any-hit: 1 / -1,
// t = t_max). Return cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a variant that is not built or a table past
// the unit capacity.
int tpurt_mxu_closest_hit(const void* o, const void* d, const void* t_min,
                          const void* t_max, const void* table,
                          const void* aabb, int R, int nc, int grp,
                          int passes, int incull, void* t_out,
                          void* tri_out, void* stream) {
    if (!units_fit(nc, grp, incull)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (R <= 0) return static_cast<int>(cudaGetLastError());
    if (incull && passes == 3) {
        return launch<3, true, false>(o, d, t_min, t_max, table, aabb, R, nc,
                                      grp, t_out, tri_out, stream);
    }
    if (!incull && passes == 3) {
        return launch<3, false, false>(o, d, t_min, t_max, table, aabb, R,
                                       nc, grp, t_out, tri_out, stream);
    }
    if (!incull && passes == 1) {
        return launch<1, false, false>(o, d, t_min, t_max, table, aabb, R,
                                       nc, grp, t_out, tri_out, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// The any-hit form exists for the in-kernel cull only, as in the
// reference's routes (any-hit under mxu3 or mxuw takes K2 or K3).
int tpurt_mxu_any_hit(const void* o, const void* d, const void* t_min,
                      const void* t_max, const void* table, const void* aabb,
                      int R, int nc, int grp, void* t_out, void* tri_out,
                      void* stream) {
    if (!units_fit(nc, grp, true)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (R <= 0) return static_cast<int>(cudaGetLastError());
    return launch<3, true, true>(o, d, t_min, t_max, table, aabb, R, nc, grp,
                                 t_out, tri_out, stream);
}

}  // extern "C"
