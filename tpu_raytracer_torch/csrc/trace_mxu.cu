// Feature-matmul traversal kernels of the PyTorch port, for Hopper
// (sm_90a): the ray-triangle test on the tensor cores.
//
//   K6  tpurt_mxu_closest_hit / tpurt_mxu_any_hit  replace
//       tpu_raytracer/ops/pallas_trace.py
//         #7 `_mt_kernel_mxu` (:1186)   modes mxu3 / mxu1: one chunk a
//            unit, 3 or 1 bf16 passes, chunk worklists;
//         #6 `_mt_kernel_mxuw` (:1070)  mode mxuw[N]: units of N chunks,
//            3 passes, group worklists;
//         #5 `_mt_kernel_mxui` (:701)   mxuf* under the in-kernel cull:
//            groups of 2 or 4 chunks slab-tested in the kernel, no
//            worklist, closest- and any-hit.
//
// det, u*det, v*det and t*det of a ray and a triangle are linear in the
// ray's 16 features phi = [o_i d_j (9), d (3), o (3), 1]
// (`mt_coef_device`, :251-307). Each 128-ray block splits its rays' phi
// into bf16 hi and lo halves in shared memory; each warp multiplies 32
// rays by the bf16 table of ops/trace_mxu.py:kernel_table (the reference's
// `mt_coef48`, one 96-byte row per column) with mma.sync m16n8k16
// (mma.cuh), 8 triangles a step with the four [det | u | v | t] column
// blocks taken together, so each thread's accumulators hold all four
// numerators of the same 4 (ray, triangle) pairs. The window test is the
// reference's (:1231-1249: sign fold, |det| > 1e-9, t = (t_n sgn) / |det|
// by IEEE division under -fmad=false; any-hit division-free, :758-765),
// and each lane keeps (t, id) lexicographically, so an exact-t tie goes
// to the lowest id. #6's block-diagonal mask (`_mxuw_mask`, :333-340)
// exists because a K = 16 dot costs the TPU's matrix unit as much as
// K = 128; here a unit's chunks are more column tiles of the same K = 16
// product: the same products, summed in another order.
//
// Numerics: the products of bf16 halves are exact; the tensor cores do
// not round each f32 addition to nearest, so t differs from the plain
// version (f64 sum, one rounding) by ulps and a winner may flip on a
// knife-edge ray. Held to the reference's tolerance, not bit for bit.
//
// What bounds it: the window test on the FP32 pipes (about 15 operations
// and one IEEE division per ray-triangle pair against K1's 46 and one),
// not the products (2 x 16 x 4 x passes FLOP a pair, 989 TFLOP/s dense
// bf16) nor bytes (the table is 384 B a triangle and stays in L2).
// What the design does about it: nothing beyond taking the products off
// the FP32 pipes. Coefficients are read from global memory per warp
// (no shared-memory staging, no TMA, no wgmma); later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "mt.cuh"

namespace {

using namespace tpurt;

constexpr int CT = 128;         // triangles per chunk
constexpr int BLOCK = 128;      // rays per block: 4 warps of 32
constexpr int MT = 2;           // 16-ray row tiles per warp
constexpr int WORDS = 24;       // 32-bit words per table row (48 bf16)

struct Shared {
    uint32_t f_hi[BLOCK][9];    // phi's bf16 halves, 8 words a ray (+1 pad)
    uint32_t f_lo[BLOCK][9];
    float red_t[BLOCK][4];      // each ray's best over its 4 column lanes
    int32_t red_id[BLOCK][4];
};

template <int PASSES, bool INCULL, bool ANY>
__global__ void __launch_bounds__(BLOCK)
mxu_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_min, const float* __restrict__ t_max,
           const uint32_t* __restrict__ table,
           const float* __restrict__ group_aabb,
           const int32_t* __restrict__ counts,
           const int32_t* __restrict__ unit_list, int R, int nc, int grp,
           float* __restrict__ t_out, int32_t* __restrict__ tri_out) {
    __shared__ Shared sh;
    const int tid = threadIdx.x;
    const int lane = tid % 32, g = lane / 4, q = lane % 4;
    const int base = blockIdx.x * BLOCK;
    const int r = base + tid;
    Ray ray = {};
    if (r < R) ray = load_ray(o, d, t_min, t_max, r, R);
    const bool live = r < R && ray.t_max > 0.0f;

    // 1. this thread's ray: phi, split into bf16 halves
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
            sh.f_hi[tid][w] = h0 | (h1 << 16);
            sh.f_lo[tid][w] = l0 | (l1 << 16);
        }
    }
    __syncthreads();

    // 2. this thread's A fragments and the windows of its 4 rays: rows
    // g and g + 8 of the warp's two 16-ray tiles
    uint32_t a_hi[MT][4], a_lo[MT][4];
    float w_lo[MT][2], w_hi[MT][2];
    float best_t[MT][2];
    int best_id[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        const int row = (tid / 32) * 32 + m * 16 + g;
        a_hi[m][0] = sh.f_hi[row][q];
        a_hi[m][1] = sh.f_hi[row + 8][q];
        a_hi[m][2] = sh.f_hi[row][q + 4];
        a_hi[m][3] = sh.f_hi[row + 8][q + 4];
        a_lo[m][0] = sh.f_lo[row][q];
        a_lo[m][1] = sh.f_lo[row + 8][q];
        a_lo[m][2] = sh.f_lo[row][q + 4];
        a_lo[m][3] = sh.f_lo[row + 8][q + 4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int rr = base + row + 8 * h;
            w_lo[m][h] = rr < R ? t_min[rr] : 0.0f;
            w_hi[m][h] = rr < R ? t_max[rr] : 0.0f;   // out of range: dead
            best_t[m][h] = INF_T;
            best_id[m][h] = -1;
        }
    }

    // 3. sweep the block's units; every thread runs every step (the
    // tensor-core product is warp-wide)
    const int n_units = INCULL ? (nc + grp - 1) / grp : counts[blockIdx.x];
    for (int i = 0; i < n_units; ++i) {
        int u = i;
        if (INCULL) {
            // the group's padded box against each live lane's window
            const bool want = live && slab_pass(group_aabb + u * 8, 1, ray,
                                                ray.t_min, ray.t_max);
            if (!__syncthreads_or(want)) continue;
        } else {
            u = unit_list[i * gridDim.x + blockIdx.x];
        }
        const int c1 = min((u + 1) * grp, nc);
        for (int c = u * grp; c < c1; ++c) {
            for (int nt = 0; nt < CT / 8; ++nt) {
                // B fragments: column n = g of the 8-triangle tile, in each
                // of the [det | u | v | t] blocks; words q, q + 4 of the hi
                // rows (k = 2q.., 2q + 8..) and q + 8, q + 12 of the lo rows
                uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
                for (int qd = 0; qd < 4; ++qd) {
                    const uint32_t* col =
                        table + ((c * 4 + qd) * CT + nt * 8 + g) * WORDS;
                    b_hi[qd][0] = __ldg(col + q);
                    b_hi[qd][1] = __ldg(col + q + 4);
                    b_lo[qd][0] = __ldg(col + q + 8);
                    b_lo[qd][1] = __ldg(col + q + 12);
                }
                float acc[MT][4][4];
                mma_split<PASSES>(acc, a_hi, a_lo, b_hi, b_lo);
#pragma unroll
                for (int m = 0; m < MT; ++m) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int h = e >> 1;
                        const float det = acc[m][0][e];
                        const float sgn = det >= 0.0f ? 1.0f : -1.0f;
                        const float d_abs = det * sgn;
                        const bool ok = d_abs > MT_EPS;
                        const float u2 = acc[m][1][e] * sgn;
                        const float v2 = acc[m][2][e] * sgn;
                        const bool inside = ok && u2 >= 0.0f && v2 >= 0.0f &&
                                            u2 + v2 <= d_abs &&
                                            w_hi[m][h] > 0.0f;
                        if (ANY) {
                            const float tn2 = acc[m][3][e] * sgn;
                            if (inside && tn2 > w_lo[m][h] * d_abs &&
                                tn2 < w_hi[m][h] * d_abs) {
                                best_id[m][h] = 1;
                            }
                        } else {
                            const float t =
                                (acc[m][3][e] * sgn) / (ok ? d_abs : 1.0f);
                            const int id = c * CT + nt * 8 + 2 * q + (e & 1);
                            if (inside && t > w_lo[m][h] && t < w_hi[m][h] &&
                                (t < best_t[m][h] ||
                                 (t == best_t[m][h] && id < best_id[m][h]))) {
                                best_t[m][h] = t;
                                best_id[m][h] = id;
                            }
                        }
                    }
                }
            }
        }
    }

    // 4. each ray's best over the 4 lanes that hold its columns
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = (tid / 32) * 32 + m * 16 + g + 8 * h;
            sh.red_t[row][q] = best_t[m][h];
            sh.red_id[row][q] = best_id[m][h];
        }
    }
    __syncthreads();
    if (r < R) {
        if (ANY) {
            bool hit = false;
            for (int j = 0; j < 4; ++j) hit = hit || sh.red_id[tid][j] >= 0;
            // the TPU any-hit contract: idx 1 or -1, t = t_max
            t_out[r] = ray.t_max;
            tri_out[r] = hit ? 1 : -1;
        } else {
            float t = INF_T;
            int id = -1;
            for (int j = 0; j < 4; ++j) {
                const float tj = sh.red_t[tid][j];
                const int ij = sh.red_id[tid][j];
                if (ij >= 0 && (id < 0 || tj < t || (tj == t && ij < id))) {
                    t = tj;
                    id = ij;
                }
            }
            t_out[r] = id >= 0 ? t : INF_T;
            tri_out[r] = id;
        }
    }
}

template <int PASSES, bool INCULL, bool ANY>
void launch(const void* o, const void* d, const void* t_min,
            const void* t_max, const void* table, const void* group_aabb,
            const void* counts, const void* unit_list, int R, int nc,
            int grp, void* t_out, void* tri_out, void* stream) {
    const dim3 grid((R + BLOCK - 1) / BLOCK);
    const auto kernel = mxu_kernel<PASSES, INCULL, ANY>;
    kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(o), static_cast<const float*>(d),
            static_cast<const float*>(t_min), static_cast<const float*>(t_max),
            static_cast<const uint32_t*>(table),
            static_cast<const float*>(group_aabb),
            static_cast<const int32_t*>(counts),
            static_cast<const int32_t*>(unit_list), R, nc, grp,
            static_cast<float*>(t_out), static_cast<int32_t*>(tri_out));
}

}  // namespace

extern "C" {

// Rays are SoA: o and d [3, R], t_min and t_max [R] (t_max <= 0 marks a
// dead lane); table [nc * 4 * 128, 48] bf16 (ops/trace_mxu.py:
// kernel_table); a unit is grp consecutive chunks. With incull, group_aabb
// [ceil(nc / grp), 8] holds the units' union boxes and every block
// slab-tests them; otherwise counts [nb] and unit_list [ceil(nc / grp),
// nb] are the worklists of the ceil(R / 128) blocks. passes: 3, or 1
// without incull. Outputs t [R] f32 and tri [R] i32 (any-hit: 1 / -1, t =
// t_max). Return cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a variant that is not built.
int tpurt_mxu_closest_hit(const void* o, const void* d, const void* t_min,
                          const void* t_max, const void* table,
                          const void* group_aabb, const void* counts,
                          const void* unit_list, int R, int nc, int grp,
                          int passes, int incull, void* t_out,
                          void* tri_out, void* stream) {
    if (R > 0) {
        if (incull && passes == 3) {
            launch<3, true, false>(o, d, t_min, t_max, table, group_aabb,
                                   counts, unit_list, R, nc, grp, t_out,
                                   tri_out, stream);
        } else if (!incull && passes == 3) {
            launch<3, false, false>(o, d, t_min, t_max, table, group_aabb,
                                    counts, unit_list, R, nc, grp, t_out,
                                    tri_out, stream);
        } else if (!incull && passes == 1) {
            launch<1, false, false>(o, d, t_min, t_max, table, group_aabb,
                                    counts, unit_list, R, nc, grp, t_out,
                                    tri_out, stream);
        } else {
            return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// The any-hit form exists for the in-kernel cull only, as in the
// reference's routes (any-hit under mxu3 or mxuw takes K2 or K3).
int tpurt_mxu_any_hit(const void* o, const void* d, const void* t_min,
                      const void* t_max, const void* table,
                      const void* group_aabb, const void* counts,
                      const void* unit_list, int R, int nc, int grp,
                      void* t_out, void* tri_out, void* stream) {
    if (R > 0) {
        launch<3, true, true>(o, d, t_min, t_max, table, group_aabb, counts,
                              unit_list, R, nc, grp, t_out, tri_out, stream);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
