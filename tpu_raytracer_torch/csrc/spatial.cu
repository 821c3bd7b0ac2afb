// ReSTIR's spatial reuse between its tap visibility queries, for Hopper
// (sm_90a).
//
//   K11  tpurt_spatial_tap / tpurt_spatial_close / tpurt_spatial_finish
//        replace no TPU kernel: the reference's spatial reuse
//        (tpu_raytracer/ops/restir.py:restir_spatial) is XLA elementwise
//        code. They replace the port's own eager version of it
//        (ops/restir.py:restir_spatial_plain, sequential taps): the tap
//        preparation (_tap_prep), the merges (_merge_tap,
//        _update_reservoir) and the finalize (_spatial_finalize) as
//        PyTorch kernels over component-major [R] vectors, ~1,200 kernels
//        a frame, each intermediate through device memory.
//
// One call of restir_spatial on the card is 7 launches of K11 around the
// queries, which stay as they are: the five tap visibility any-hit calls
// (scene_occluded: K2, K3, K4, K5, K6 or K8 by the scene's route) and the
// winners' replay (trace_path: K9 and its queries).
//   tap(0)   the own reservoir's M clamp and w_sum rescale, the pixel's
//            surface and raw-LCG seed, then tap 0: its two draws, the disk
//            offset, the neighbour's row read through the comb view, the
//            validity and Jacobian tests and the shadow ray to the
//            neighbour's first vertex, written in place for the any-hit
//            call that follows;
//   tap(t)   t = 1..4: tap t - 1 merged from the last any-hit answer (its
//            reservoir draw only where the tap was not blocked), then tap t
//            prepared as tap 0 is;
//   close    tap 4 merged; the replay's inputs written in place: the
//            winners' seeds and the mask of lanes whose winner carries no
//            valid radiance cache;
//   finish   after the replay: the cached / replayed radiance, p_hat, W
//            and its clamp to MAX_W, the HDR word, the next frame's
//            cache, the clears of invalid lanes, and the f32 folds of
//            `ray_count` and `diag` from exact integer counts.
// The comb view is a BandView (one [rows, GB_COLS + RES_COLS] table) or a
// PairBandView (a G-buffer table and a reservoir table, each with its row
// stride); a neighbour read reproduces parallel/views.py:_band_index: the
// clamp of its row and column, the halo rows, and coverage.
//
// Numerics: every lane reproduces the eager CUDA route, not an
// approximation of it. Each eager op is one rounded f32 op here, in the
// same order, from the same f32 constants (a Python float is rounded to
// f32 once, after Python folded any constant subexpression in double);
// dot products sum (x*x + y*y) + z*z; torch.clamp keeps a NaN; float-to-int
// casts truncate (the disk offsets, the rows' material ids and M); cosf,
// sinf and sqrtf are the CUDA library's, as PyTorch's CUDA kernels call
// them; `/` and sqrtf are IEEE (-fmad=false, no fast math). Every
// division of the stage is by a tensor, so none takes the product with
// the f32 reciprocal that PyTorch's CUDA kernel makes of a division by a
// Python float (`div_scalar`, csrc/path_trace.cu); `1.0 / x` is
// reciprocal(x) * 1.0, an IEEE division. The seed's uint32 bits ride as
// they are. RNG draws come in the eager order and count: a lane draws
// only where the eager mask lets it.
// The merges add `where(ok, w, 0.0)` to every lane's w_sum, as the eager
// version does (a -0 becomes +0). `ray_count` is the eager f32 sum, tap by
// tap, of exact per-tap counts (block counts and one atomic a block), plus
// the replay's rays; `diag` is its two exact counts as f32.
//
// What bounds it: bytes. A pixel must read its G-buffer words (37 B: pos,
// oct normal, albedo, material id, valid), its temporal reservoir (48 B)
// and five neighbour rows (104 B each, but at most 10 px away: the rows
// in flight fit in L2 and come from DRAM about once), and write its
// output reservoir (48 B), its HDR word (12 B) and five shadow rays
// (17 B each), read five any-hit answers (1 B each), and hand the replay
// its seed and mask (9 B) and read back its radiance and vertex (24 B):
// ~270 B a pixel, 0.25 GB at 1280x720 (0.074 ms at 3.35 TB/s) and 0.56 GB
// at 1920x1080 (0.17 ms). The arithmetic, ~300 f32 operations and a sinf
// and cosf a tap, is far under the card's rate.
// What the design does about it: one thread a lane, lane state SoA so
// every load and store of a warp is coalesced, nothing between launches
// but that state and the rays. The state is 20 B a lane (RNG word, the
// running reservoir's w_sum, M and seed, a flags word), and 12 B more
// where a tap's ray goes to the query (its weight, M and seed, so a merge
// reads no neighbour row again). The surface is read again from the
// G-buffer each launch, as cheap as storing it. Each tap launch then moves
// ~110 B a lane of its own and one neighbour row from L2, ~4x the bound
// over the 7 launches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;
constexpr int TAPS = 5;                 // ops/restir.py:TAPS
constexpr int MAX_M_SPATIAL = 20;
constexpr float MAX_W = 20.0f;
// the material table's columns (scene/builder.py:_pack_tables)
constexpr int MAT_ROUGH = 7, MAT_METAL = 8, MAT_TRANS = 9;
// a reservoir row's columns (ops/restir.py:pack_reservoirs)
constexpr int R_Y = 0, R_M = 2, R_W = 3, R_PHAT = 4, R_SPATH = 5;

#define F32(x) static_cast<float>(x)
constexpr float TWO_PI = F32(2.0 * 3.141592653589793);   // 2.0 * math.pi
constexpr float INV_U32_MAX = F32(1.0 / 4294967295.0);

// a lane's flags word
constexpr uint32_t F_PENDING = 1u;      // its tap's shadow ray went to the query
constexpr uint32_t F_TAKEN = 2u;        // a tap won: rad 0, rad_ok false
// the counts: the taps' shadow rays, then the cached and the valid lanes
constexpr int C_CACHED = TAPS, C_LANES = TAPS + 1, N_COUNTS = TAPS + 2;

struct SpatialArgs {
    // the band's G-buffer, with element strides
    const float* gb_pos;
    const float* gb_oct;
    const float* gb_albedo;
    const int32_t* gb_mat;
    const uint8_t* gb_valid;
    // the own (temporal) reservoir, [R] each, with element strides
    const int64_t* in_y;
    const float* in_w_sum;
    const int32_t* in_m;
    const float* in_sx;
    const float* in_sy;
    const float* in_sz;
    const float* in_rx;
    const float* in_ry;
    const float* in_rz;
    const uint8_t* in_rad_ok;
    const float* mat_table;            // [n_mat, mat_cols]
    const float* view;                 // the camera position, 3 words
    const int64_t* frame;              // the 0-dim counter, or null
    // the comb view: G-buffer rows and reservoir rows, each with its row
    // stride; columns adjacent
    const float* nb_gb;
    const float* nb_res;
    int64_t pos_s0, pos_s1, oct_s0, oct_s1, alb_s0, alb_s1, mat_s, valid_s;
    int64_t y_s, w_sum_s, m_s, sx_s, sy_s, sz_s, rx_s, ry_s, rz_s, rad_ok_s;
    int64_t view_s, nb_gb_s, nb_res_s;
    int64_t frame_value;               // the counter where `frame` is null
    int n_mat, mat_cols;
    int width, height, y0, band_h, R;  // the band (ctx)
    int v_y0, v_width, v_height, v_band_h, v_halo;   // the comb view
    // the packed G-buffer's columns (ops/gbuffer.py)
    int gb_pos_c, gb_oct_c, gb_albedo_c, gb_mat_c, gb_valid_c;
    // lane state, SoA [R]
    uint32_t* rng;
    float* w_sum;
    int32_t* m;
    uint32_t* y;
    uint32_t* flags;
    float* tw;                         // the pending tap's weight,
    int32_t* tm;                       // clamped M
    uint32_t* ty;                      // and seed
    int32_t* counts;                   // [N_COUNTS]
    // the taps' shadow rays: origin and direction [3, R], window and mask
    // [R], and the last any-hit call's answer [R]
    float* ray_o;
    float* ray_d;
    float* t_max;
    uint8_t* active;
    const uint8_t* blocked;
    // the replay: its seeds (also the output y) and mask, written by
    // close; its radiance and first vertex [R, 3] and rays, read by finish
    int64_t* seed;
    uint8_t* replay;
    const float* radiance;
    const float* v1_pos;
    const float* path_rays;
    // outputs
    float* out_w_sum;
    int32_t* out_m;
    float* out_w;
    float* out_p_hat;
    float* out_spath;                  // [3, R]
    float* out_rad;                    // [3, R]
    uint8_t* out_rad_ok;
    float* hdr;                        // [R, 3]
    float* rays;                       // 0-dim each
    float* cached;
    float* lanes;
};

// ---------------------------------------------------------------------------
// f32 ops as PyTorch's elementwise kernels compute them
// ---------------------------------------------------------------------------

struct V {
    float x, y, z;
};

__device__ __forceinline__ V sub(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V mul(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V divs(V a, float s) { return {a.x / s, a.y / s, a.z / s}; }

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.clamp(x, min=lo): NaN stays; else ::max on the card, and on the
// host the CPU kernel's `lo > x ? lo : x` (as csrc/post.cu)
__device__ __forceinline__ float clamp_lo(float x, float lo) {
#ifdef TPURT_HOST_EMULATION
    return isnan_(x) ? x : (lo > x ? lo : x);
#else
    return isnan_(x) ? x : fmaxf(x, lo);
#endif
}
// torch.clamp(x, lo, hi) with scalar bounds
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
    if (isnan_(x)) return x;
#ifdef TPURT_HOST_EMULATION
    const float m = lo > x ? lo : x;
    return hi < m ? hi : m;
#else
    return fminf(fmaxf(x, lo), hi);
#endif
}

__device__ __forceinline__ float dot(V a, V b) {
    return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ float length(V v) {
    return sqrtf(clamp_lo(dot(v, v), 0.0f));
}
__device__ __forceinline__ V normalize(V v) {
    return divs(v, clamp_lo(length(v), F32(1e-6)));
}
__device__ __forceinline__ float luminance(V c) {
    return (c.x * F32(0.2126) + c.y * F32(0.7152)) + c.z * F32(0.0722);
}
// utils/vec3.py:oct_decode
__device__ __forceinline__ V oct_decode(float ex, float ey) {
    const float nz = (1.0f - fabsf(ex)) - fabsf(ey);
    const float t = clamp_lo(-nz, 0.0f);
    return normalize({ex + (ex >= 0.0f ? -t : t), ey + (ey >= 0.0f ? -t : t), nz});
}

// utils/rng.py:rand_lcg: the raw-LCG step, its output hashed
__device__ __forceinline__ float draw_lcg(uint32_t& st) {
    st = st * 747796405u + 2891336453u;
    const uint32_t w = ((st >> ((st >> 28) + 4u)) ^ st) * 277803737u;
    return static_cast<float>((w >> 22) ^ w) * INV_U32_MAX;
}

__device__ __forceinline__ void store3(float* p, int64_t stride, int i, V v) {
    p[i] = v.x;
    p[stride + i] = v.y;
    p[2 * stride + i] = v.z;
}

// ---------------------------------------------------------------------------
// The pixel's surface (restir._spatial_surface) and one tap (_tap_prep)
// ---------------------------------------------------------------------------

struct Surface {
    V pos, normal, albedo, cam;
    int mat, gx, gy, num_neighbors;
    bool valid, is_specular, valid_spec;
    float radius;
};

__device__ Surface load_surface(const SpatialArgs& a, int i) {
    Surface s;
    const int64_t p = i * a.pos_s0, o = i * a.oct_s0, b = i * a.alb_s0;
    s.pos = {a.gb_pos[p], a.gb_pos[p + a.pos_s1], a.gb_pos[p + 2 * a.pos_s1]};
    s.normal = oct_decode(a.gb_oct[o], a.gb_oct[o + a.oct_s1]);
    s.albedo = {a.gb_albedo[b], a.gb_albedo[b + a.alb_s1],
                a.gb_albedo[b + 2 * a.alb_s1]};
    s.cam = {a.view[0], a.view[a.view_s], a.view[2 * a.view_s]};
    s.mat = a.gb_mat[i * a.mat_s];
    s.valid = a.gb_valid[i * a.valid_s] != 0;
    s.gx = i % a.width;
    s.gy = a.y0 + i / a.width;
    int mid = s.mat < 0 ? 0 : s.mat;
    mid = mid > a.n_mat - 1 ? a.n_mat - 1 : mid;
    const float* mt = a.mat_table + static_cast<int64_t>(mid) * a.mat_cols;
    const float rough = mt[MAT_ROUGH], metal = mt[MAT_METAL], trans = mt[MAT_TRANS];
    s.is_specular = rough < F32(0.1) || metal > F32(0.9) || trans > F32(0.1);
    s.valid_spec = rough < F32(0.2) || metal > F32(0.8) || trans > F32(0.01);
    s.num_neighbors = s.is_specular ? 3 : 5;
    s.radius = s.is_specular ? 4.0f : 10.0f;
    return s;
}

// Tap `tap` of lane i: its draws, neighbour and tests; writes its shadow
// ray and, where the ray goes to the query, what the merge needs.
// Returns the lane's flags, with F_PENDING set where the ray goes.
__device__ uint32_t prep_tap(const SpatialArgs& a, int i, const Surface& s,
                             int tap, uint32_t& st, uint32_t fl) {
    const bool it_active = s.valid && tap < s.num_neighbors;
    const float r1 = it_active ? draw_lcg(st) : 0.0f;
    const float r2 = it_active ? draw_lcg(st) : 0.0f;
    const float angle = TWO_PI * r1;
    const float rad = sqrtf(r2) * s.radius;
    const int nx = s.gx + static_cast<int>(cosf(angle) * rad);
    const int ny = s.gy + static_cast<int>(sinf(angle) * rad);

    // views.py:_band_index on the comb view
    const int cover = a.v_band_h + 2 * a.v_halo;
    const int local_row = ny - a.v_y0 + a.v_halo;
    const bool cov = local_row >= 0 && local_row < cover && ny >= 0 &&
                     ny < a.v_height && nx >= 0 && nx < a.v_width;
    const int lr = local_row < 0 ? 0 : (local_row > cover - 1 ? cover - 1 : local_row);
    const int lc = nx < 0 ? 0 : (nx > a.v_width - 1 ? a.v_width - 1 : nx);
    const int64_t idx = static_cast<int64_t>(lr) * a.v_width + lc;
    const float* g = a.nb_gb + idx * a.nb_gb_s;
    const float* r = a.nb_res + idx * a.nb_res_s;

    const V n_pos = {g[a.gb_pos_c], g[a.gb_pos_c + 1], g[a.gb_pos_c + 2]};
    const V n_norm = oct_decode(g[a.gb_oct_c], g[a.gb_oct_c + 1]);
    const V n_alb = {g[a.gb_albedo_c], g[a.gb_albedo_c + 1], g[a.gb_albedo_c + 2]};
    const int n_mat = static_cast<int>(g[a.gb_mat_c]);
    bool ok = it_active && cov && g[a.gb_valid_c] > 0.5f;

    // _is_valid_neighbor_spatial
    const float ndot = dot(s.normal, n_norm);
    const V dd = sub(s.pos, n_pos);
    const float dist_diff_sq = dot(dd, dd);
    const V dc = sub(s.pos, s.cam);
    const float threshold = clamp_lo(dot(dc, dc) * F32(1e-3), F32(1e-5));
    const bool spec_ok = ndot >= F32(0.998) && sqrtf(dist_diff_sq) <= F32(0.01);
    const bool diff_ok = ndot >= F32(0.995) && dist_diff_sq <= threshold;
    ok = ok && s.mat == n_mat && (s.valid_spec ? spec_ok : diff_ok);

    const float nb_p_hat = r[R_PHAT];
    const V nb_spath = {r[R_SPATH], r[R_SPATH + 1], r[R_SPATH + 2]};
    ok = ok && nb_p_hat > 0.0f;

    // _calculate_jacobian
    const float cos_curr = clamp_lo(dot(s.normal, normalize(sub(nb_spath, s.pos))), 0.0f);
    const float cos_neigh = clamp_lo(dot(n_norm, normalize(sub(nb_spath, n_pos))), 0.0f);
    float jac = cos_curr / clamp_lo(cos_neigh, F32(1e-12));
    const float lum_curr = luminance(s.albedo) + F32(1e-3);
    const float lum_neigh = luminance(n_alb) + F32(1e-3);
    jac = clamp2(jac * (lum_curr / lum_neigh), F32(0.1), 10.0f);
    jac = cos_neigh <= F32(1e-3) ? 0.0f : jac;
    ok = ok && !(s.is_specular && (jac < 0.5f || jac > 2.0f));

    // the visibility re-check to the neighbour's v1
    const V dir_to_v1 = sub(nb_spath, s.pos);
    const float dist = length(dir_to_v1);
    const bool shadow = ok && dot(s.normal, dir_to_v1) > 0.0f && dist > F32(1e-3);
    store3(a.ray_d, a.R, i, divs(dir_to_v1, clamp_lo(dist, F32(1e-12))));
    a.t_max[i] = clamp_lo(dist * F32(0.999), 0.0f);
    a.active[i] = shadow;
    if (!shadow) return fl;

    const int nb_m = static_cast<int>(r[R_M]);
    const int m_new = nb_m > MAX_M_SPATIAL ? MAX_M_SPATIAL : nb_m;
    a.tw[i] = nb_p_hat * jac * r[R_W] * F32(m_new);
    a.tm[i] = m_new;
    a.ty[i] = __float_as_uint(r[R_Y]);
    return fl | F_PENDING;
}

// The pending tap into the running reservoir (_merge_tap), from the last
// any-hit answer: every lane's w_sum gets where(ok, w, 0.0).
__device__ uint32_t merge_tap(const SpatialArgs& a, int i, uint32_t& st,
                              uint32_t fl, float& w_sum, int& m, uint32_t& y) {
    const bool ok = (fl & F_PENDING) && a.blocked[i] == 0;
    if (!ok) {
        w_sum = w_sum + 0.0f;
        return fl & ~F_PENDING;
    }
    const float rnd = draw_lcg(st);
    const float w = a.tw[i];
    w_sum = w_sum + w;
    if (rnd * w_sum < w) {
        y = a.ty[i];
        fl |= F_TAKEN;
    }
    m = m + a.tm[i];
    return fl & ~F_PENDING;
}

// Block counts of `c` into counts[slot] (every thread of the block calls).
__device__ __forceinline__ void count(const SpatialArgs& a, int slot, int c) {
    const int n = __syncthreads_count(c);
    if (threadIdx.x == 0 && n > 0) atomicAdd(a.counts + slot, n);
}

// ---------------------------------------------------------------------------
// The launches
// ---------------------------------------------------------------------------

// tap(0) starts the lane; tap(t > 0) merges tap t - 1 and counts its rays.
__device__ void tap_lane(const SpatialArgs& a, int i, int tap, int& counted) {
    const Surface s = load_surface(a, i);
    uint32_t st, fl, y;
    float w_sum;
    int m;
    if (tap == 0) {
        // the own reservoir, M-clamped with w_sum rescale
        m = a.in_m[i * a.m_s];
        w_sum = a.in_w_sum[i * a.w_sum_s];
        if (m > MAX_M_SPATIAL) {
            w_sum = w_sum * F32(MAX_M_SPATIAL) / F32(m < 1 ? 1 : m);
            m = MAX_M_SPATIAL;
        }
        y = static_cast<uint32_t>(a.in_y[i * a.y_s]);
        fl = 0;
        const int64_t gidx = static_cast<int64_t>(s.gy) * a.width + s.gx;
        const uint32_t frame = static_cast<uint32_t>(
            a.frame != nullptr ? *a.frame : a.frame_value);
        st = static_cast<uint32_t>(gidx) + frame * 0x12345678u;
        store3(a.ray_o, a.R, i, s.pos);
    } else {
        st = a.rng[i];
        fl = a.flags[i];
        w_sum = a.w_sum[i];
        m = a.m[i];
        y = a.y[i];
        counted = (fl & F_PENDING) != 0;
        fl = merge_tap(a, i, st, fl, w_sum, m, y);
    }
    fl = prep_tap(a, i, s, tap, st, fl);
    a.rng[i] = st;
    a.flags[i] = fl;
    a.w_sum[i] = w_sum;
    a.m[i] = m;
    a.y[i] = y;
}

__global__ void __launch_bounds__(BLOCK) spatial_tap(SpatialArgs a, int tap) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (tap == 0 && blockIdx.x == 0 && threadIdx.x < N_COUNTS) a.counts[threadIdx.x] = 0;
    int counted = 0;
    if (i < a.R) tap_lane(a, i, tap, counted);
    if (tap > 0) count(a, tap - 1, counted);
}

// close: tap 4 merged, the replay's seeds and mask
__global__ void __launch_bounds__(BLOCK) spatial_close(SpatialArgs a, int) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    int counted = 0, cached = 0, valid = 0;
    if (i < a.R) {
        uint32_t st = a.rng[i], y = a.y[i];
        float w_sum = a.w_sum[i];
        int m = a.m[i];
        uint32_t fl = a.flags[i];
        counted = (fl & F_PENDING) != 0;
        fl = merge_tap(a, i, st, fl, w_sum, m, y);
        const bool rad_ok = !(fl & F_TAKEN) && a.in_rad_ok[i * a.rad_ok_s] != 0;
        valid = a.gb_valid[i * a.valid_s] != 0;
        cached = rad_ok && valid;
        a.seed[i] = static_cast<int64_t>(y);
        a.replay[i] = !rad_ok;
        a.rng[i] = st;
        a.flags[i] = fl;
        a.w_sum[i] = w_sum;
        a.m[i] = m;
    }
    count(a, TAPS - 1, counted);
    count(a, C_CACHED, cached);
    count(a, C_LANES, valid);
}

// finish: _spatial_finalize after the replay
__global__ void __launch_bounds__(BLOCK) spatial_finish(SpatialArgs a, int) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i < a.R) {
        const V zero = {0.0f, 0.0f, 0.0f};
        V rad = zero, spath = zero, hdr = zero;
        float w_sum = 0.0f, w = 0.0f, p_hat = 0.0f;
        int m = 0;
        const bool valid = a.gb_valid[i * a.valid_s] != 0;
        if (valid) {
            const bool cached = !(a.flags[i] & F_TAKEN) &&
                                a.in_rad_ok[i * a.rad_ok_s] != 0;
            const int64_t k = 3 * static_cast<int64_t>(i);
            if (cached) {
                rad = {a.in_rx[i * a.rx_s], a.in_ry[i * a.ry_s], a.in_rz[i * a.rz_s]};
                spath = {a.in_sx[i * a.sx_s], a.in_sy[i * a.sy_s], a.in_sz[i * a.sz_s]};
            } else {
                rad = {a.radiance[k], a.radiance[k + 1], a.radiance[k + 2]};
                spath = {a.v1_pos[k], a.v1_pos[k + 1], a.v1_pos[k + 2]};
            }
            const float p_hat_final = luminance(rad);
            w_sum = a.w_sum[i];
            m = a.m[i];
            const float m_f = clamp_lo(F32(m), 1.0f);
            if (p_hat_final > 0.0f) {
                const float w_unclamped =
                    (1.0f / clamp_lo(p_hat_final, F32(1e-20))) * (w_sum / m_f);
                w = clamp2(w_unclamped, 0.0f, MAX_W);
                p_hat = p_hat_final;
                hdr = mul(rad, w);
            }
        } else {
            a.seed[i] = 0;
        }
        a.out_w_sum[i] = w_sum;
        a.out_m[i] = m;
        a.out_w[i] = w;
        a.out_p_hat[i] = p_hat;
        store3(a.out_spath, a.R, i, spath);
        store3(a.out_rad, a.R, i, rad);
        a.out_rad_ok[i] = valid;
        a.hdr[3 * static_cast<int64_t>(i)] = hdr.x;
        a.hdr[3 * static_cast<int64_t>(i) + 1] = hdr.y;
        a.hdr[3 * static_cast<int64_t>(i) + 2] = hdr.z;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        float rays = 0.0f;
        for (int t = 0; t < TAPS; ++t) rays = rays + F32(a.counts[t]);
        *a.rays = rays + *a.path_rays;
        *a.cached = F32(a.counts[C_CACHED]);
        *a.lanes = F32(a.counts[C_LANES]);
    }
}

// Launches `kernel` over the lanes of the SpatialArgs at `args`, at least
// one block: tap(0) zeroes the counts, finish folds them.
template <class K>
int launch(K kernel, const void* args, int tap, void* stream) {
    const SpatialArgs& a = *static_cast<const SpatialArgs*>(args);
    const int blocks = a.R > BLOCK ? (a.R + BLOCK - 1) / BLOCK : 1;
    kernel<<<dim3(blocks), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(a, tap);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One restir_spatial call: tap(0), then after each any-hit call tap(t) for
// t = 1..4, then close, the replay, finish, each given a SpatialArgs
// (ops/restir.py: SpatialArgs, run_k11). Each returns cudaGetLastError()
// after its launch.
int tpurt_spatial_tap(const void* args, int tap, void* stream) {
    if (tap < 0 || tap >= TAPS) return cudaErrorInvalidValue;
    return launch(spatial_tap, args, tap, stream);
}

int tpurt_spatial_close(const void* args, void* stream) {
    return launch(spatial_close, args, 0, stream);
}

int tpurt_spatial_finish(const void* args, void* stream) {
    return launch(spatial_finish, args, 0, stream);
}

}  // extern "C"
