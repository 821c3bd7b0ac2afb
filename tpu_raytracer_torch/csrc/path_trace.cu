// The path tracer's shading between its trace queries, for Hopper (sm_90a).
//
//   K9  tpurt_path_prime / tpurt_path_bounce / tpurt_path_finish replace
//       no TPU kernel: the reference's path tracer
//       (tpu_raytracer/ops/path_trace.py:trace_path) is XLA elementwise
//       code. They replace the port's own eager version of it
//       (ops/path_trace.py:trace_path_plain), which ran every BSDF, NEE,
//       MIS, texture and RNG step as PyTorch kernels over [R] lanes:
//       ~11,760 kernels a call, each intermediate through device memory.
//
// One call of trace_path on the card is 9 launches of K9 between the trace
// queries, which stay as they are (K1/K2, K3, K4, K5, K6 or K8, through
// scene_trace): `prime` (depth 0 from the G-buffer), `bounce` once at each
// depth 1-7, `finish`. Each depth makes one query, as the eager version
// makes it: [this depth's shadow rays | the next bounce rays] as one
// closest-hit query ([3, 2R] rays; [3, R] bounce rays alone in a scene
// without lights), and at depth 7 the shadow rays alone as an any-hit
// query. A launch reads the last query's answer, folds it into its lane's
// state, shades the vertex and writes the next query's rays in place.
//
// Numerics: every lane reproduces the eager CUDA route, not an
// approximation of it. Each eager op is one rounded f32 op here, in the
// same order, from the same f32 constants (a Python float is rounded to
// f32 once, after Python folded any constant subexpression in double);
// dot products sum (x*x + y*y) + z*z; integer powers multiply in JAX's
// order; torch.clamp keeps a NaN (it is not fminf/fmaxf); texel wrap is a
// floor-mod; float-to-int casts truncate; `/` and sqrtf are IEEE
// (-fmad=false, no fast math). A tensor divided by a Python float is, on
// the card, a product with the f32 reciprocal (PyTorch's div_true_kernel
// for a CPU scalar); on the host, in the emulation that the CPU tests
// build, it is a true division as PyTorch's CPU kernel computes it
// (`div_scalar`). RNG draws come in the eager order and count: a lane
// draws only where the eager mask lets it. Zero terms the eager version
// adds to a dead lane (x + 0 * throughput) are added once, at `finish`:
// they change nothing but the sign of a zero, or give NaN where the
// throughput is not finite, as theirs do. `rays` is folded at `finish`
// from exact per-depth integer counts (block counts and one atomic a
// block) in the eager order of f32 adds.
//
// What bounds it: bytes. A live lane moves ~230-300 B a depth: its state
// (RNG word, throughput, radiance, pending NEE term, last BSDF pdf, flags)
// in and out, its bounce ray in, its hit, and 64 B of rays out. Table
// rows (triangle, instance, material, light) and bf16 texels are read
// one row a lane and come from L2. The arithmetic (~1-2 kFLOP a lane and
// depth, a few sinf/cosf) is far under the card's rate.
// What the design does about it: one thread a lane, lane state SoA so
// every load and store of a warp is coalesced, nothing but the state and
// the rays between launches, every intermediate in registers. A lane
// with nothing left to do (dead, no shadow answer pending) reads its
// flags word and returns, so late depths and the masked lanes of the
// spatial replay cost 4 B each.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 128;
constexpr int MAX_DEPTH = 8;     // ops/path_trace.py:MAX_DEPTH
constexpr int RR_START_DEPTH = 3;
constexpr int NO_TEXTURE = 0xFFFF;

#define F32(x) static_cast<float>(x)
constexpr double PI_D = 3.1415927410125732;   // f32 pi (bsdf.PI) as double
constexpr float PI_F = F32(PI_D);
constexpr float TWO_PI_F = F32(2.0 * PI_D);   // `2.0 * PI` folded in double
constexpr float INV_U32_MAX = F32(1.0 / 4294967295.0);
constexpr float T_MIN = F32(1e-3);
constexpr float T_MAX = F32(100.0);

// texture channels (scene.tex_channels), the wrapper's TEX_BITS
constexpr int TEX_COLOR = 1, TEX_OCCLUSION = 2, TEX_NORMAL = 4,
              TEX_EMISSIVE = 8, TEX_MR = 16;

// a lane's flags word
constexpr uint32_t F_ALIVE = 1u;      // its bounce ray went to the query
constexpr uint32_t F_SHADOW = 2u;     // its shadow ray went to the query
constexpr uint32_t F_PREV_DIFFUSE = 4u;
constexpr uint32_t F_GLASS0 = 8u;     // the primary surface is glass
constexpr uint32_t F_ZPEND = 16u;     // dead: x + 0 * throughput owed
constexpr int ZNAN_SHIFT = 8;         // 3 bits: 0 * thr_pre[k] is NaN
constexpr int ZNEG_SHIFT = 11;        // 3 bits: 0 * thr_pre[k] is -0

struct PathArgs {
    // scene: tables row-major [rows, cols] f32, textures [L, H, W, 3] bf16
    const float* tri_table;
    const float* inst_table;
    const float* mat_table;
    const float* light_table;
    const uint16_t* color_tex;
    const uint16_t* data_tex;
    int tri_cols, inst_cols, mat_cols, light_cols;
    int n_inst, n_mat, n_light, num_lights;
    int c_layers, c_h, c_w, d_layers, d_h, d_w;
    int tex, instanced, R, N;          // N: the dual query's columns
    float inv_lights;                  // 1.0 / max(num_lights, 1), as f32
    // G-buffer and call inputs, with their element strides
    const float* gb_pos;
    const float* gb_oct;
    const float* gb_uv;
    const float* gb_albedo;
    const int32_t* gb_mat;
    const uint8_t* gb_valid;
    const uint8_t* mask;               // null: every lane
    const int64_t* seed;
    const float* view;
    int64_t pos_s0, pos_s1, oct_s0, oct_s1, uv_s0, uv_s1, alb_s0, alb_s1;
    int64_t mat_s, valid_s, mask_s, seed_s, view_s;
    // lane state, SoA ([3, R] for vectors)
    uint32_t* rng;
    uint32_t* flags;
    float* thr;
    float* acc;
    float* nee;                        // pending NEE term, contrib * thr_pre
    float* pdf;                        // last BSDF pdf
    // the dual query: rays [3, N], window [N], and its answer [N]
    float* ray_o;
    float* ray_d;
    float* t_min;
    float* t_max;
    const float* hit_t;
    const int32_t* hit_tri;
    const int32_t* hit_inst;
    // the last depth's shadow rays [3, R] and its any-hit answer [R]
    float* so;
    float* sd;
    float* s_tmax;
    const int32_t* occ;
    // outputs
    float* radiance;                   // [R, 3]
    uint8_t* valid_v1;
    float* v1_pos;                     // [R, 3]
    float* v1_normal;                  // [R, 3]
    int64_t* state;
    float* rays;                       // 0-dim
    int32_t* counts;                   // [2 * MAX_DEPTH]
};

// ---------------------------------------------------------------------------
// f32 ops as PyTorch's elementwise kernels compute them
// ---------------------------------------------------------------------------

struct V {
    float x, y, z;
};

__device__ __forceinline__ V add(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V sub(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V mul(V a, V b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V mul(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V divs(V a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V adds(V a, float s) { return {a.x + s, a.y + s, a.z + s}; }
__device__ __forceinline__ V subs(V a, float s) { return {a.x - s, a.y - s, a.z - s}; }
__device__ __forceinline__ V rsubs(float s, V a) { return {s - a.x, s - a.y, s - a.z}; }
__device__ __forceinline__ V neg(V a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.clamp(x, min=lo) / (max=hi) / (lo, hi): NaN stays NaN
__device__ __forceinline__ float cmin(float x, float lo) {
    return isnan_(x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float cmax(float x, float hi) {
    return isnan_(x) ? x : (x > hi ? hi : x);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return cmax(cmin(x, lo), hi);
}
// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmaximum(float a, float b) {
    if (isnan_(a)) return a;
    if (isnan_(b)) return b;
    return a > b ? a : b;
}
// torch.sign: (0 < x) - (x < 0), 0 for NaN
__device__ __forceinline__ float tsign(float x) {
    return static_cast<float>((0.0f < x) - (x < 0.0f));
}
// a tensor divided by a Python float (see the header)
__device__ __forceinline__ float div_scalar(float x, float s) {
#ifdef TPURT_HOST_EMULATION
    return x / s;
#else
    return x * (1.0f / s);
#endif
}

__device__ __forceinline__ float dot(V a, V b) {
    return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ V cross(V a, V b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float length(V v) {
    return sqrtf(cmin(dot(v, v), 0.0f));
}
__device__ __forceinline__ V normalize(V v) {
    return divs(v, cmin(length(v), F32(1e-6)));
}
__device__ __forceinline__ float ipow5(float x) {    // JAX integer_pow order
    const float x2 = x * x;
    const float x4 = x2 * x2;
    return x * x4;
}
__device__ __forceinline__ float luminance(V c) {
    return (c.x * F32(0.2126) + c.y * F32(0.7152)) + c.z * F32(0.0722);
}
__device__ __forceinline__ V reflect(V v, V n) {
    return sub(v, mul(n, dot(v, n) * 2.0f));
}
__device__ __forceinline__ V refract(V v, V n, float eta) {
    const float cos_i = -dot(v, n);
    const float sin2_t = (eta * eta) * (1.0f - cos_i * cos_i);
    float k = 1.0f - sin2_t;
    const bool tir = k < 0.0f;
    k = cmin(k, 0.0f);
    const V out = add(mul(v, eta), mul(n, eta * cos_i - sqrtf(k)));
    return tir ? V{0.0f, 0.0f, 0.0f} : out;
}

// ---------------------------------------------------------------------------
// RNG (utils/rng.py): PCG hash streams
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
    const uint32_t s = x * 747796405u + 2891336453u;
    const uint32_t w = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
    return (w >> 22) ^ w;
}
__device__ __forceinline__ float draw(uint32_t& st) {
    st = pcg_hash(st);
    return static_cast<float>(st) * INV_U32_MAX;
}

// ---------------------------------------------------------------------------
// Table rows and textures
// ---------------------------------------------------------------------------

__device__ __forceinline__ const float* row(const float* table, int idx,
                                            int rows, int cols) {
    idx = idx > rows - 1 ? rows - 1 : idx;
    idx = idx < 0 ? 0 : idx;
    return table + static_cast<int64_t>(idx) * cols;
}

struct Mat {
    V base, emis;
    float rough, metal, trans, ior;
    int light, tex, ntex, otex, etex, mrtex;
};

__device__ Mat load_mat(const PathArgs& a, int id) {
    const float* c = row(a.mat_table, id, a.n_mat, a.mat_cols);
    Mat m;
    m.base = {__ldg(c + 0), __ldg(c + 1), __ldg(c + 2)};
    m.emis = {__ldg(c + 4), __ldg(c + 5), __ldg(c + 6)};
    m.rough = __ldg(c + 7);
    m.metal = __ldg(c + 8);
    m.trans = __ldg(c + 9);
    m.ior = __ldg(c + 10);
    m.light = static_cast<int>(__ldg(c + 11));
    m.tex = static_cast<int>(__ldg(c + 12));
    m.ntex = static_cast<int>(__ldg(c + 13));
    m.otex = static_cast<int>(__ldg(c + 14));
    m.etex = static_cast<int>(__ldg(c + 15));
    m.mrtex = static_cast<int>(__ldg(c + 16));
    return m;
}

struct Tex {
    const uint16_t* p;
    int layers, h, w;
};

__device__ __forceinline__ float bf16(const uint16_t* p, int64_t i) {
    return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
}

__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
    int64_t r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}

// textures.sample_bilinear: `nch` channels (1: x only, as the occlusion
// read takes); NO_TEXTURE lanes read 1.0
__device__ V sample(const Tex& t, int layer, float u, float v, int nch = 3) {
    if (layer == NO_TEXTURE) return {1.0f, 1.0f, 1.0f};
    const int64_t base =
        static_cast<int64_t>(layer > t.layers - 1 ? t.layers - 1 : layer) *
        (static_cast<int64_t>(t.h) * t.w);
    const float x = u * static_cast<float>(t.w) - 0.5f;
    const float y = v * static_cast<float>(t.h) - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int64_t xi0 = floor_mod(static_cast<int64_t>(x0), t.w);
    const int64_t yi0 = floor_mod(static_cast<int64_t>(y0), t.h);
    const int64_t xi1 = floor_mod(xi0 + 1, t.w);
    const int64_t yi1 = floor_mod(yi0 + 1, t.h);
    const int64_t i00 = (base + yi0 * t.w + xi0) * 3;
    const int64_t i10 = (base + yi0 * t.w + xi1) * 3;
    const int64_t i01 = (base + yi1 * t.w + xi0) * 3;
    const int64_t i11 = (base + yi1 * t.w + xi1) * 3;
    float out[3] = {1.0f, 1.0f, 1.0f};
    for (int k = 0; k < nch; ++k) {
        const float top = bf16(t.p, i00 + k) * (1.0f - fx) +
                          bf16(t.p, i10 + k) * fx;
        const float bot = bf16(t.p, i01 + k) * (1.0f - fx) +
                          bf16(t.p, i11 + k) * fx;
        out[k] = top * (1.0f - fy) + bot * fy;
    }
    return {out[0], out[1], out[2]};
}

__device__ __forceinline__ Tex color_tex(const PathArgs& a) {
    return {a.color_tex, a.c_layers, a.c_h, a.c_w};
}
__device__ __forceinline__ Tex data_tex(const PathArgs& a) {
    return {a.data_tex, a.d_layers, a.d_h, a.d_w};
}

// path_trace._surface_color
__device__ V surface_color(const PathArgs& a, const Mat& m, float u, float v) {
    V bc = m.base;
    if (a.tex & TEX_COLOR) bc = mul(bc, sample(color_tex(a), m.tex, u, v));
    if (a.tex & TEX_OCCLUSION) {
        bc = mul(bc, sample(data_tex(a), m.otex, u, v, 1).x);
    }
    return bc;
}

// hit.apply_normal_map, for a lane whose material has the map
__device__ V apply_normal_map(V ffn, V tangent, float tw, V rgb) {
    const V nl = normalize(subs(mul(rgb, 2.0f), 1.0f));
    const V t_ff = normalize(sub(tangent, mul(ffn, dot(ffn, tangent))));
    const V b_ff = mul(normalize(cross(ffn, t_ff)), tw);
    return normalize(add(add(mul(t_ff, nl.x), mul(b_ff, nl.y)),
                         mul(ffn, nl.z)));
}

// ---------------------------------------------------------------------------
// Hit reconstruction (ops/hit.py:reconstruct_hit)
// ---------------------------------------------------------------------------

struct Hit {
    V pos, normal, ffn, tangent;
    float u, v, tw, t;
    int mat_id;
    bool front;
};

__device__ __forceinline__ V matvec9(const float* m, V v) {
    return {(__ldg(m + 0) * v.x + __ldg(m + 1) * v.y) + __ldg(m + 2) * v.z,
            (__ldg(m + 3) * v.x + __ldg(m + 4) * v.y) + __ldg(m + 5) * v.z,
            (__ldg(m + 6) * v.x + __ldg(m + 7) * v.y) + __ldg(m + 8) * v.z};
}

__device__ __forceinline__ V col3(const float* c, int k) {
    return {__ldg(c + k), __ldg(c + k + 1), __ldg(c + k + 2)};
}

// ray (o, d) hit triangle `tri` (of instance `inst`) at the query's t
__device__ Hit reconstruct_hit(const PathArgs& a, int tri, int inst, V o,
                               V d, float t_hit, bool want_tangent) {
    const float* c = a.tri_table + static_cast<int64_t>(tri < 0 ? 0 : tri) *
                                       a.tri_cols;
    const float* ic = nullptr;
    V ro = o, rd = d;
    if (a.instanced) {
        ic = row(a.inst_table, inst, a.n_inst, a.inst_cols);
        ro = add(matvec9(ic, o), col3(ic, 9));
        rd = matvec9(ic, d);
    }
    const V v0 = col3(c, 26), e1 = col3(c, 29), e2 = col3(c, 32);
    const V pvec = cross(rd, e2);
    const float det = dot(e1, pvec);
    const bool det_ok = fabsf(det) > F32(1e-9);
    const float inv_det = det_ok ? 1.0f / det : 0.0f;
    const V tvec = sub(ro, v0);
    const float u = dot(tvec, pvec) * inv_det;
    const V qvec = cross(tvec, e1);
    const float v = dot(rd, qvec) * inv_det;
    Hit h;
    h.front = a.instanced ? det * __ldg(ic + 21) > 0.0f : det > 0.0f;
    h.t = det_ok ? dot(e2, qvec) * inv_det : t_hit;
    const float w = (1.0f - u) - v;
    V n = add(add(mul(col3(c, 0), w), mul(col3(c, 3), u)), mul(col3(c, 6), v));
    if (a.instanced) n = matvec9(ic + 12, n);
    h.normal = normalize(n);
    h.u = (__ldg(c + 9) * w + __ldg(c + 11) * u) + __ldg(c + 13) * v;
    h.v = (__ldg(c + 10) * w + __ldg(c + 12) * u) + __ldg(c + 14) * v;
    if (want_tangent) {
        V tg = add(add(mul(col3(c, 15), w), mul(col3(c, 18), u)),
                   mul(col3(c, 21), v));
        if (a.instanced) tg = matvec9(ic + 12, tg);
        h.tangent = normalize(tg);
    }
    h.tw = __ldg(c + 24);
    h.mat_id = static_cast<int>(a.instanced ? __ldg(ic + 22) : __ldg(c + 25));
    h.pos = add(o, mul(d, h.t));
    h.ffn = h.front ? h.normal : neg(h.normal);
    return h;
}

// ---------------------------------------------------------------------------
// BSDF (ops/bsdf.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ V fresnel_schlick(V f0, float v_dot_h) {
    const float c5 = ipow5(clampf(1.0f - v_dot_h, 0.0f, 1.0f));
    return add(f0, mul(rsubs(1.0f, f0), c5));
}

__device__ __forceinline__ float reflectance(float cosine, float ref_idx) {
    float r0 = (1.0f - ref_idx) / (ref_idx + 1.0f);
    r0 = r0 * r0;
    return r0 + (1.0f - r0) * ipow5(1.0f - cosine);
}

__device__ __forceinline__ float ndf_ggx(float n_dot_h, float roughness) {
    const float a = roughness * roughness;
    const float a2 = a * a;
    const float d = (n_dot_h * n_dot_h) * (a2 - 1.0f) + 1.0f;
    return a2 / cmin(d * PI_F * d, F32(1e-20));
}

__device__ __forceinline__ float g1_ggx(float n_dot_v, float roughness) {
    const float a2 = roughness * roughness;
    return n_dot_v * 2.0f /
           cmin(n_dot_v + sqrtf(a2 + (1.0f - a2) * n_dot_v * n_dot_v),
                F32(1e-12));
}

__device__ __forceinline__ V mix_f0(V base, float metallic) {
    return adds(mul(subs(base, F32(0.04)), metallic), F32(0.04));
}

// the Fresnel-luminance lobe probability at (normal, wo)
__device__ float spec_prob(V base, float metallic, V n, V wo) {
    const V f_view = fresnel_schlick(mix_f0(base, metallic),
                                     cmin(dot(n, wo), 0.0f));
    const float lum_spec = luminance(f_view);
    const float lum_diff = luminance(mul(base, 1.0f - metallic));
    return clampf(lum_spec / ((lum_spec + lum_diff) + F32(1e-4)),
                  F32(0.001), F32(0.999));
}

// bsdf.eval_pdf, given its lobe probability at (normal, wo)
__device__ float eval_pdf(V normal, V wi, V wo, const Mat& m, float prob) {
    const float n_dot_l = dot(normal, wi);
    const float n_dot_v = dot(normal, wo);
    const V h = normalize(add(wi, wo));
    const float n_dot_h = cmin(dot(normal, h), 0.0f);
    const float d = ndf_ggx(n_dot_h, m.rough);
    const float g1 = g1_ggx(cmin(n_dot_v, F32(1e-6)), m.rough);
    const float pdf_spec = (d * g1) / cmin(n_dot_v * 4.0f, F32(1e-6));
    const float pdf_diff = div_scalar(cmin(n_dot_l, 0.0f), PI_F);
    const float pdf = prob * pdf_spec + (1.0f - prob) * pdf_diff;
    const bool invalid = m.trans > F32(0.01) || n_dot_l <= 0.0f ||
                         n_dot_v <= 0.0f;
    return invalid ? 0.0f : pdf;
}

// bsdf.eval_bsdf
__device__ V eval_bsdf(V normal, V wi, V wo, const Mat& m, V base) {
    const float n_dot_l = dot(normal, wi);
    const float n_dot_v = dot(normal, wo);
    const V h = normalize(add(wi, wo));
    const float n_dot_h = cmin(dot(normal, h), 0.0f);
    const float h_dot_v = cmin(dot(h, wo), 0.0f);
    const V f0 = mix_f0(base, m.metal);
    const float d = ndf_ggx(n_dot_h, m.rough);
    const float g = g1_ggx(cmin(n_dot_l, F32(1e-6)), m.rough) *
                    g1_ggx(cmin(n_dot_v, F32(1e-6)), m.rough);
    const V f = fresnel_schlick(f0, h_dot_v);
    const V specular = divs(mul(f, d * g),
                            cmin(n_dot_l * 4.0f * n_dot_v, F32(1e-3)));
    const V kd = mul(rsubs(1.0f, f), 1.0f - m.metal);
    const V kb = mul(kd, base);
    const V diffuse = {div_scalar(kb.x, PI_F), div_scalar(kb.y, PI_F),
                       div_scalar(kb.z, PI_F)};
    const bool invalid = m.trans > F32(0.01) || n_dot_l <= 0.0f ||
                         n_dot_v <= 0.0f;
    return invalid ? V{0.0f, 0.0f, 0.0f} : add(diffuse, specular);
}

// bsdf.sample_ggx_vndf
__device__ V sample_ggx_vndf(V wl, float roughness, float u1, float u2) {
    const float alpha = roughness * roughness;
    const V vh = normalize({alpha * wl.x, alpha * wl.y, wl.z});
    const float lensq = vh.x * vh.x + vh.y * vh.y;
    const bool pos_len = lensq > 0.0f;
    const float inv_len =
        pos_len ? 1.0f / sqrtf(cmin(lensq, F32(1e-20))) : 0.0f;
    const V t1 = {pos_len ? -vh.y * inv_len : 1.0f,
                  pos_len ? vh.x * inv_len : 0.0f, 0.0f};
    const V t2 = cross(vh, t1);
    const float r = sqrtf(u1);
    const float phi = u2 * TWO_PI_F;
    const float p1 = r * cosf(phi);
    const float p2 = r * sinf(phi);
    const float s = (vh.z + 1.0f) * 0.5f;
    const float p2_lerp =
        (1.0f - s) * sqrtf(cmin(1.0f - p1 * p1, 0.0f)) + s * p2;
    const V nh = add(add(mul(t1, p1), mul(t2, p2_lerp)),
                     mul(vh, sqrtf(cmin(1.0f - p1 * p1 - p2_lerp * p2_lerp,
                                        0.0f))));
    return normalize({alpha * nh.x, alpha * nh.y, cmin(nh.z, 0.0f)});
}

struct Bsdf {
    V wi, weight;
    float pdf;
};

// bsdf.sample_bsdf for a live lane (the eager mask `active` holds)
__device__ Bsdf sample_bsdf(uint32_t& st, V wo, V ffn, bool front,
                            const Mat& m, V base) {
    Bsdf out;
    if (m.trans > F32(0.01)) {      // glass delta lobe
        const float r_glass = draw(st);
        const float ratio = front ? 1.0f / m.ior : m.ior;
        const float cos_theta = cmax(dot(wo, ffn), 1.0f);
        const float sin_theta = sqrtf(cmin(1.0f - cos_theta * cos_theta, 0.0f));
        const bool do_reflect = ratio * sin_theta > 1.0f ||
                                reflectance(cos_theta, ratio) > r_glass;
        out.wi = do_reflect ? reflect(neg(wo), ffn)
                            : refract(neg(wo), ffn, ratio);
        out.pdf = 0.0f;
        out.weight = base;
        return out;
    }
    const float prob = spec_prob(base, m.metal, ffn, wo);
    const float r_lobe = draw(st);
    const float r1 = draw(st);
    const float r2 = draw(st);
    V wi;
    if (r_lobe < prob) {
        // vec3.orthonormal_basis, to_local, to_world
        const float sgn = ffn.z >= 0.0f ? 1.0f : -1.0f;
        const float a = (1.0f / (sgn + ffn.z)) * -1.0f;
        const float b = ffn.x * ffn.y * a;
        const V tangent = {sgn * ffn.x * ffn.x * a + 1.0f, sgn * b,
                           -sgn * ffn.x};
        const V bitangent = {b, sgn + ffn.y * ffn.y * a, -ffn.y};
        const V wo_local = {dot(wo, tangent), dot(wo, bitangent), dot(wo, ffn)};
        const V wm_local = sample_ggx_vndf(wo_local, m.rough, r1, r2);
        const V wm = add(add(mul(tangent, wm_local.x),
                             mul(bitangent, wm_local.y)),
                         mul(ffn, wm_local.z));
        wi = reflect(neg(wo), wm);
    } else {
        const float z = r1 * 2.0f - 1.0f;
        const float a = r2 * TWO_PI_F;
        const float rxy = sqrtf(cmin(1.0f - z * z, 0.0f));
        wi = normalize(add(ffn, V{rxy * cosf(a), rxy * sinf(a), z}));
    }
    const float n_dot_l = dot(ffn, wi);
    const float n_dot_v = dot(ffn, wo);
    const bool valid = n_dot_l > 0.0f && n_dot_v > 0.0f;
    const V f = eval_bsdf(ffn, wi, wo, m, base);
    const float pdf = eval_pdf(ffn, wi, wo, m, prob);
    out.wi = wi;
    out.pdf = valid ? pdf : 0.0f;
    out.weight = valid && pdf > 0.0f
                     ? divs(mul(f, n_dot_l), cmin(pdf, F32(1e-20)))
                     : V{0.0f, 0.0f, 0.0f};
    return out;
}

// ---------------------------------------------------------------------------
// NEE (path_trace._nee_draw, lights.sample_light)
// ---------------------------------------------------------------------------

struct Shadow {
    V o, d, contrib;
    float t_max;
};

// The NEE draws of a lane under the eager `nee_mask`; true if its shadow
// ray is live (`shadow_active`), with the ray and the untested term.
__device__ bool nee_draw(const PathArgs& a, uint32_t& st, V pos, V ffn,
                         V wo, const Mat& m, V base, Shadow& s) {
    if (a.num_lights == 0) return false;
    const float r_pick = draw(st);
    const int light_idx =
        static_cast<int>(floorf(r_pick * static_cast<float>(a.num_lights)));
    if (!(light_idx < a.num_lights)) return false;
    const float r1 = draw(st);
    const float r2 = draw(st);
    const float* c = row(a.light_table, light_idx, a.n_light, a.light_cols);
    const V position = col3(c, 0), u_vec = col3(c, 4), v_vec = col3(c, 8);
    const float area = __ldg(c + 7);
    V lpos, lnormal;
    if (static_cast<int>(__ldg(c + 3)) == 0) {     // quad
        const float su = r1 * 2.0f - 1.0f;
        const float sv = r2 * 2.0f - 1.0f;
        lpos = add(add(position, mul(u_vec, su)), mul(v_vec, sv));
        lnormal = normalize(cross(u_vec, v_vec));
    } else {                                       // sphere
        const float z = 1.0f - r1 * 2.0f;
        const float r_xy = sqrtf(cmin(1.0f - z * z, 0.0f));
        const float phi = r2 * TWO_PI_F;
        lnormal = {r_xy * cosf(phi), r_xy * sinf(phi), z};
        lpos = add(position, mul(lnormal, v_vec.x));
    }
    const float pdf_nee = (1.0f / cmin(area, F32(1e-12))) * a.inv_lights;
    const V to_light = normalize(sub(lpos, pos));
    const float prob = spec_prob(base, m.metal, ffn, wo);
    const float p_bsdf = eval_pdf(ffn, to_light, wo, m, prob);
    const float mis_weight = pdf_nee / cmin(pdf_nee + p_bsdf, F32(1e-20));
    const float weight = mis_weight / cmin(pdf_nee, F32(1e-20));

    const V offset_pos = add(pos, mul(ffn, F32(1e-3)));
    const V delta = sub(lpos, offset_pos);
    const float dist = length(delta);
    const V l_dir = divs(delta, cmin(dist, F32(1e-12)));
    const float n_dot_l = cmin(dot(ffn, l_dir), 0.0f);
    const float l_dot_n = cmin(dot(neg(l_dir), lnormal), 0.0f);
    if (!(n_dot_l > 0.0f && l_dot_n > 0.0f)) return false;

    const V f = eval_bsdf(ffn, l_dir, wo, m, base);
    const float g = (n_dot_l * l_dot_n) / cmin(dist * dist, F32(1e-12));
    const V emission = col3(c, 11);
    s.contrib = mul(mul(mul(emission, __ldg(c + 14)), f), g * weight);
    s.o = offset_pos;
    s.d = l_dir;
    s.t_max = cmin(dist * F32(0.999), 0.0f);
    return true;
}

// ---------------------------------------------------------------------------
// Lane state
// ---------------------------------------------------------------------------

__device__ __forceinline__ V load3(const float* p, int64_t stride, int i) {
    return {p[i], p[stride + i], p[2 * stride + i]};
}
__device__ __forceinline__ void store3(float* p, int64_t stride, int i, V v) {
    p[i] = v.x;
    p[stride + i] = v.y;
    p[2 * stride + i] = v.z;
}
__device__ __forceinline__ void store_row3(float* p, int i, V v) {
    p[3 * static_cast<int64_t>(i) + 0] = v.x;
    p[3 * static_cast<int64_t>(i) + 1] = v.y;
    p[3 * static_cast<int64_t>(i) + 2] = v.z;
}

__device__ __forceinline__ void put_ray(float* o, float* d, float* t_max,
                                        int64_t n, int col, V ro, V rd,
                                        float tm) {
    store3(o, n, col, ro);
    store3(d, n, col, rd);
    t_max[col] = tm;
}

// the term 0 * thr_pre, coded into flag bits
__device__ __forceinline__ uint32_t zero_bits(V thr_pre) {
    const float z[3] = {0.0f * thr_pre.x, 0.0f * thr_pre.y, 0.0f * thr_pre.z};
    uint32_t bits = 0;
    for (int k = 0; k < 3; ++k) {
        if (isnan_(z[k])) bits |= 1u << (ZNAN_SHIFT + k);
        if (!isnan_(z[k]) && __float_as_uint(z[k]) != 0u) {
            bits |= 1u << (ZNEG_SHIFT + k);
        }
    }
    return bits;
}
__device__ __forceinline__ float zero_of(uint32_t fl, int k) {
    if (fl & (1u << (ZNAN_SHIFT + k))) return __uint_as_float(0x7fc00000u);
    return (fl & (1u << (ZNEG_SHIFT + k))) ? -0.0f : 0.0f;
}

// The NEE step of a live lane (nee_mask and what the eager version adds
// for it). Shadow ray to column `col` of (o, d, t_max) [3, n].
__device__ uint32_t nee_step(const PathArgs& a, int i, uint32_t& st,
                             bool nee_mask, V pos, V ffn, V wo, const Mat& m,
                             V base, V thr_pre, V& acc, float* o, float* d,
                             float* t_max, int64_t n, int col) {
    Shadow s;
    if (nee_mask && nee_draw(a, st, pos, ffn, wo, m, base, s)) {
        store3(a.nee, a.R, i, mul(s.contrib, thr_pre));
        if (o != nullptr) put_ray(o, d, t_max, n, col, s.o, s.d, s.t_max);
        return F_SHADOW | zero_bits(thr_pre);
    }
    // no shadow ray: its term is 0 * thr_pre, added now (nothing else
    // touches acc before the eager version adds it)
    acc = add(acc, mul(thr_pre, 0.0f));
    if (o != nullptr) t_max[col] = 0.0f;
    return 0u;
}

// the pending shadow term of a lane, its ray blocked or not
__device__ __forceinline__ V shadow_term(const PathArgs& a, int i,
                                         uint32_t fl, bool blocked) {
    if (!blocked) return load3(a.nee, a.R, i);
    return {zero_of(fl, 0), zero_of(fl, 1), zero_of(fl, 2)};
}

// Block counts of `c` into counts[slot] (every thread of the block calls).
__device__ __forceinline__ void count(const PathArgs& a, int slot, int c) {
    const int n = __syncthreads_count(c);
    if (threadIdx.x == 0 && n > 0) atomicAdd(a.counts + slot, n);
}

// ---------------------------------------------------------------------------
// prime: depth 0 from the G-buffer (path_trace._trace_path before its loop)
// ---------------------------------------------------------------------------

__device__ void prime_lane(const PathArgs& a, int i) {
    const int R = a.R;
    const int64_t N = a.N;
    const int s_col = i, b_col = a.num_lights > 0 ? R + i : i;
    uint32_t st = static_cast<uint32_t>(a.seed[i * a.seed_s]);
    a.t_min[b_col] = T_MIN;
    if (a.num_lights > 0) a.t_min[s_col] = T_MIN;
    a.valid_v1[i] = 0;
    store_row3(a.v1_pos, i, {0.0f, 0.0f, 0.0f});
    store_row3(a.v1_normal, i, {0.0f, 0.0f, 0.0f});
    put_ray(a.so, a.sd, a.s_tmax, R, i, {0.0f, 0.0f, 0.0f},
            {0.0f, 0.0f, 0.0f}, 0.0f);
    V zero = {0.0f, 0.0f, 0.0f};
    const bool active = a.gb_valid[i * a.valid_s] != 0 &&
                        (a.mask == nullptr || a.mask[i * a.mask_s] != 0);
    uint32_t fl = 0;
    V acc = zero;
    if (!active) {
        put_ray(a.ray_o, a.ray_d, a.t_max, N, b_col, zero, zero, 0.0f);
        if (a.num_lights > 0) {
            put_ray(a.ray_o, a.ray_d, a.t_max, N, s_col, zero, zero, 0.0f);
        }
    } else {
        const V pos = {a.gb_pos[i * a.pos_s0], a.gb_pos[i * a.pos_s0 + a.pos_s1],
                       a.gb_pos[i * a.pos_s0 + 2 * a.pos_s1]};
        const float ex = a.gb_oct[i * a.oct_s0];
        const float ey = a.gb_oct[i * a.oct_s0 + a.oct_s1];
        const float u = a.gb_uv[i * a.uv_s0];
        const float v = a.gb_uv[i * a.uv_s0 + a.uv_s1];
        // vec3.oct_decode
        const float nz = (1.0f - fabsf(ex)) - fabsf(ey);
        const float tt = cmin(-nz, 0.0f);
        const V ffn = normalize({ex + (ex >= 0.0f ? -tt : tt),
                                 ey + (ey >= 0.0f ? -tt : tt), nz});
        Mat m = load_mat(a, a.gb_mat[i * a.mat_s]);
        const V base = {a.gb_albedo[i * a.alb_s0],
                        a.gb_albedo[i * a.alb_s0 + a.alb_s1],
                        a.gb_albedo[i * a.alb_s0 + 2 * a.alb_s1]};
        if ((a.tex & TEX_MR) && m.mrtex != NO_TEXTURE) {
            const V mr = sample(data_tex(a), m.mrtex, u, v);
            m.metal = mr.z * m.metal;
            m.rough = mr.y * m.rough;
        }
        const V view = {a.view[0], a.view[a.view_s], a.view[2 * a.view_s]};
        const V wo = normalize(sub(view, pos));

        // primary emission; light-source pixels terminate
        V emission = m.emis;
        if (a.tex & TEX_EMISSIVE) {
            emission = mul(emission, sample(color_tex(a), m.etex, u, v));
        }
        acc = add(acc, emission);
        if (m.light >= 0) {
            acc = add(acc, zero);                // its 0 * 1 NEE term
            put_ray(a.ray_o, a.ray_d, a.t_max, N, b_col, zero, zero, 0.0f);
            if (a.num_lights > 0) {
                put_ray(a.ray_o, a.ray_d, a.t_max, N, s_col, zero, zero, 0.0f);
            }
        } else {
            const bool glass0 = m.trans > F32(0.01);
            const bool nee_mask = !(glass0 || m.rough < F32(0.05));
            const V ones = {1.0f, 1.0f, 1.0f};
            fl |= nee_step(a, i, st, nee_mask, pos, ffn, wo, m, base, ones,
                           acc, a.num_lights > 0 ? a.ray_o : nullptr,
                           a.ray_d, a.t_max, N, s_col);
            if (nee_mask) fl |= F_PREV_DIFFUSE;
            if (glass0) fl |= F_GLASS0;

            const Bsdf sc = sample_bsdf(st, wo, ffn, true, m, base);
            const bool alive = !(sc.weight.x <= 0.0f && sc.weight.y <= 0.0f &&
                                 sc.weight.z <= 0.0f);
            store3(a.thr, R, i, mul(ones, sc.weight));
            a.pdf[i] = sc.pdf;
            const V origin = add(pos, mul(mul(ffn, tsign(dot(ffn, sc.wi))),
                                          F32(1e-3)));
            put_ray(a.ray_o, a.ray_d, a.t_max, N, b_col, origin, sc.wi,
                    alive ? T_MAX : 0.0f);
            fl |= alive ? F_ALIVE : F_ZPEND;
        }
    }
    store3(a.acc, R, i, acc);
    a.rng[i] = st;
    a.flags[i] = fl;
}

// Zeroes the counts, which the bounces fill: the first bounce counts this
// depth's shadow rays from the lanes' flags.
__global__ void __launch_bounds__(BLOCK) path_prime(PathArgs a, int) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (blockIdx.x == 0 && threadIdx.x < 2 * MAX_DEPTH) a.counts[threadIdx.x] = 0;
    if (i < a.R) prime_lane(a, i);
}

// ---------------------------------------------------------------------------
// bounce: depth 1-7 (one turn of path_trace._trace_path's loop)
// ---------------------------------------------------------------------------

// the lane's part of depth `depth`: fills (last_shadow, counted, shadow)
// for the counts
__device__ void bounce_lane(const PathArgs& a, int i, int depth,
                            int& last_shadow, int& counted, int& shadow) {
    const int R = a.R;
    const int64_t N = a.N;
    const bool last = depth + 1 >= MAX_DEPTH;
    const bool lights = a.num_lights > 0;
    const int s_col = i, b_col = lights ? R + i : i;
    uint32_t fl = a.flags[i];
    if (!(fl & (F_ALIVE | F_SHADOW))) return;

    // the last query: this lane's shadow answer, then its bounce hit
    V acc = load3(a.acc, R, i);
    last_shadow = (fl & F_SHADOW) != 0;
    if (fl & F_SHADOW) {
        acc = add(acc, shadow_term(a, i, fl, a.hit_tri[s_col] >= 0));
    }
    fl &= ~(F_SHADOW | (0x3fu << ZNAN_SHIFT));
    float* so = last ? a.so : a.ray_o;
    float* sd = last ? a.sd : a.ray_d;
    float* stm = last ? a.s_tmax : a.t_max;
    const int64_t sn = last ? R : N;
    if (!(fl & F_ALIVE)) {
        if (lights) stm[s_col] = 0.0f;
        store3(a.acc, R, i, acc);
        a.flags[i] = fl;
        return;
    }
    uint32_t st = a.rng[i];
    V thr = load3(a.thr, R, i);
    bool alive = true;

    // Russian roulette, drawn before this depth's hit is consumed
    if (depth >= RR_START_DEPTH) {
        const float r_rr = draw(st);
        const float survival =
            clampf(tmaximum(tmaximum(thr.x, thr.y), thr.z), F32(0.05),
                   F32(0.95));
        if (r_rr > survival) {
            alive = false;
        } else {
            thr = divs(thr, survival);
        }
    }
    const int tri = a.hit_tri[b_col];
    if (alive) {
        counted = 1;
        alive = tri >= 0;
    }
    bool reached_nee = false;      // its zero terms are then settled
    if (alive) {
        const V o = load3(a.ray_o, N, b_col);
        const V d = load3(a.ray_d, N, b_col);
        const Hit h = reconstruct_hit(a, tri, a.instanced ? a.hit_inst[b_col] : 0,
                                      o, d, a.hit_t[b_col],
                                      (a.tex & TEX_NORMAL) != 0);
        if (depth == 1) {           // the reconnection vertex
            a.valid_v1[i] = 1;
            store_row3(a.v1_pos, i, h.pos);
            store_row3(a.v1_normal, i, h.normal);
        }
        const V wo = neg(d);
        const Mat m = load_mat(a, h.mat_id);
        const V base = surface_color(a, m, h.u, h.v);
        V ffn = h.ffn;
        if ((a.tex & TEX_NORMAL) && m.ntex != NO_TEXTURE) {
            ffn = apply_normal_map(ffn, h.tangent, h.tw,
                                   sample(data_tex(a), m.ntex, h.u, h.v));
        }
        // emissive texture of non-light materials
        if (a.tex & TEX_EMISSIVE) {
            const bool em_mask = m.light == -1 && m.etex != NO_TEXTURE;
            const V em = em_mask ? sample(color_tex(a), m.etex, h.u, h.v)
                                 : V{0.0f, 0.0f, 0.0f};
            acc = add(acc, mul(em, thr));
        }
        // emissive light hit with MIS
        const bool light_hit = m.light >= 0;
        V le_mis = {0.0f, 0.0f, 0.0f};
        if (light_hit && h.front) {
            const float* c = row(a.light_table, m.light, a.n_light,
                                 a.light_cols);
            const V le = mul(col3(c, 11), __ldg(c + 14));
            const float light_cos = cmin(dot(ffn, neg(wo)), 0.0f);
            const float p_nee =
                (1.0f / cmin(__ldg(c + 7), F32(1e-12))) *
                ((h.t * h.t) / cmin(light_cos, F32(1e-12))) * a.inv_lights;
            float mis = light_cos > F32(1e-3)
                            ? a.pdf[i] / cmin(a.pdf[i] + p_nee, F32(1e-20))
                            : 0.0f;
            if (!(fl & F_PREV_DIFFUSE)) mis = 1.0f;
            le_mis = mul(le, mis);
        }
        acc = add(acc, mul(le_mis, thr));
        alive = !light_hit;
        if (alive) {
            // NEE, the primary surface's glass flag (reference quirk)
            reached_nee = true;
            const bool nee_mask = !((fl & F_GLASS0) || m.rough < F32(0.05));
            fl = (fl & ~F_PREV_DIFFUSE) | (nee_mask ? F_PREV_DIFFUSE : 0u);
            fl |= nee_step(a, i, st, nee_mask, h.pos, ffn, wo, m, base, thr,
                           acc, lights ? so : nullptr, sd, stm, sn, s_col);
            shadow = (fl & F_SHADOW) != 0;

            const Bsdf sc = sample_bsdf(st, wo, ffn, h.front, m, base);
            alive = !(sc.weight.x <= 0.0f && sc.weight.y <= 0.0f &&
                      sc.weight.z <= 0.0f);
            if (alive) thr = mul(thr, sc.weight);
            a.pdf[i] = sc.pdf;
            if (!last) {
                const V origin = add(h.pos, mul(mul(ffn, tsign(dot(ffn, sc.wi))),
                                                F32(1e-3)));
                put_ray(a.ray_o, a.ray_d, a.t_max, N, b_col, origin, sc.wi,
                        alive ? T_MAX : 0.0f);
            }
        }
    }
    if (!alive) {
        // zero terms follow a death before this depth's NEE, and one after
        // it unless this is the last depth
        fl &= ~F_ALIVE;
        if (!reached_nee || !last) fl |= F_ZPEND;
        if (!reached_nee) {
            if (lights) stm[s_col] = 0.0f;
            if (!last) a.t_max[b_col] = 0.0f;
        }
    }
    store3(a.acc, R, i, acc);
    store3(a.thr, R, i, thr);
    a.rng[i] = st;
    a.flags[i] = fl;
}

__global__ void __launch_bounds__(BLOCK) path_bounce(PathArgs a, int depth) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    int last_shadow = 0, counted = 0, shadow = 0;
    if (i < a.R) bounce_lane(a, i, depth, last_shadow, counted, shadow);
    if (depth == 1) count(a, 0, last_shadow);
    count(a, 2 * depth - 1, counted);
    count(a, 2 * depth, shadow);
}

// ---------------------------------------------------------------------------
// finish: the last shadow answer, the owed zero terms, the outputs
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK) path_finish(PathArgs a, int) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i < a.R) {
        const uint32_t fl = a.flags[i];
        V acc = load3(a.acc, a.R, i);
        if (fl & F_SHADOW) {
            acc = add(acc, shadow_term(a, i, fl, a.occ[i] >= 0));
        }
        if (fl & F_ZPEND) acc = add(acc, mul(load3(a.thr, a.R, i), 0.0f));
        store_row3(a.radiance, i, acc);
        a.state[i] = static_cast<int64_t>(a.rng[i]);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        float rays = static_cast<float>(a.counts[0]);
        for (int k = 1; k < 2 * MAX_DEPTH - 1; ++k) {
            rays = rays + static_cast<float>(a.counts[k]);
        }
        *a.rays = rays;
    }
}

// Launches `kernel` over the lanes of the PathArgs at `args`, at least one
// block: prime zeroes the counts, finish folds them.
template <class K>
int launch(K kernel, const void* args, int depth, void* stream) {
    const PathArgs& a = *static_cast<const PathArgs*>(args);
    const int blocks = a.R > BLOCK ? (a.R + BLOCK - 1) / BLOCK : 1;
    kernel<<<dim3(blocks), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        a, depth);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One trace_path call: prime, then after each query bounce(depth) for
// depth 1..7, then finish, each given a PathArgs (ops/path_trace.py:
// PathArgs, run_k9). Each returns cudaGetLastError() after its launch.
int tpurt_path_prime(const void* args, void* stream) {
    return launch(path_prime, args, 0, stream);
}

int tpurt_path_bounce(const void* args, int depth, void* stream) {
    if (depth < 1 || depth >= MAX_DEPTH) return cudaErrorInvalidValue;
    return launch(path_bounce, args, depth, stream);
}

int tpurt_path_finish(const void* args, void* stream) {
    return launch(path_finish, args, 0, stream);
}

}  // extern "C"
