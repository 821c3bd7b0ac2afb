// The post pass of one row band, for Hopper (sm_90a).
//
//   K10  tpurt_post  replaces no TPU kernel: the reference's post pass
//        (tpu_raytracer/ops/post.py:post_process) is XLA elementwise and
//        roll code. It replaces the port's own eager version of it
//        (ops/post.py:post_process_plain), which ran each of the 25
//        bilateral taps as rolls of 11 component planes plus a dozen
//        vector ops: ~3,900 PyTorch kernels a frame, each intermediate
//        through device memory.
//
// One launch a band a frame, one thread a pixel of the band: the 5x5
// joint bilateral over the HDR view, the 3x3 YCoCg variance bounds, the
// bilinear history read of the accumulation view through the motion
// vector, the static / moving blend, the inverse tonemap into the new
// accumulation rows and the gamma-2.2 LDR rows.
//
// Numerics: every pixel reproduces the eager CUDA route, not an
// approximation of it. Each eager op is one rounded f32 op here, in the
// same order, from the same f32 constants (a Python float is rounded to
// f32 once, after Python folded any constant subexpression in double);
// dot products sum (x*x + y*y) + z*z; x^20 multiplies in JAX's integer_pow
// order; expf, powf and sqrtf are the CUDA library's, as PyTorch's CUDA
// kernels call them; `/` and sqrtf are IEEE (-fmad=false, no fast math).
// A tensor divided by a Python float is, on the card, a product with the
// f32 reciprocal (PyTorch's div_true_kernel for a CPU scalar); on the
// host, in the emulation that the CPU tests build, a true division as
// PyTorch's CPU kernel computes it (`div_scalar`, as csrc/path_trace.cu).
// torch.clamp and torch.maximum keep a NaN, and otherwise compare as
// PyTorch's kernels of that platform do (`clamp_lo`, `clamp2`). A stencil
// tap reads what the eager version's torch.roll reads: rows wrap modulo
// the view's band_h + 2 * halo rows, columns modulo the width; a tap
// outside the image is multiplied by 0 (ok) in the bilateral, so a
// non-finite word there gives NaN as the eager product does, and replaced
// by the pixel's own filtered colour in the 3x3 pass (torch.where). The
// history taps clamp their index and test their coverage as
// parallel/views.py:_band_index does, and a tap outside is 0.
//
// What bounds it: bytes. A pixel needs its HDR word (12 B), 40 B of its
// G-buffer row (position, oct normal, albedo, motion) and an accumulation
// word (12 B; up to four, mostly its own, through L1/L2), and writes 24 B:
// 88 B a pixel, 81 MB at 1280x720 (0.024 ms at 3.35 TB/s). The packed
// rows are 56 B and adjacent, so DRAM moves all of each: 104 B a pixel
// in this layout. The arithmetic, ~2,000 f32 operations and 50 expf a
// pixel, is well under the card's rate.
// What the design does about it: a block of 32 x 8 pixels stages a tile
// of 36 x 12 texels (its pixels with a 2-pixel apron) into shared memory
// once: HDR, albedo, position and the normal, decoded from its oct pair
// once a texel and not once a tap (12 words, 20,736 B a block). The 25 +
// 9 taps of each pixel then read shared memory, a warp's 32 lanes on 32
// neighbouring words. The 3x3 pass runs only where its result is used (a
// moving pixel with valid history), and the history words are read only
// where the history is valid; both leave the other pixels' results as
// they are, since the eager version selects them away with torch.where.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BW = 32;                 // pixels a block, across
constexpr int BH = 8;                  // pixels a block, down
constexpr int THREADS = BW * BH;
constexpr int RADIUS = 2;              // ops/post.py:KERNEL_RADIUS
constexpr int TW = BW + 2 * RADIUS;
constexpr int TH = BH + 2 * RADIUS;
constexpr int TEXELS = TW * TH;
constexpr int TAPS = (2 * RADIUS + 1) * (2 * RADIUS + 1);

// tile channels
constexpr int T_HDR = 0, T_ALBEDO = 3, T_NORMAL = 6, T_POS = 9, T_CH = 12;

#define F32(x) static_cast<float>(x)
// `-x2 / (2.0 * sigma * sigma)` of ops/post.py:_gauss, folded in double
constexpr float TWO_SIGMA_COLOR2 = F32(2.0 * 0.2 * 0.2);
constexpr float TWO_SIGMA_POS2 = F32(2.0 * 0.1 * 0.1);
constexpr float NINTH = F32(1.0 / 9.0);
constexpr float VARIANCE_GAMMA = F32(1.2);
constexpr float FEEDBACK_HI = F32(0.98);
constexpr float FEEDBACK_SPAN = F32(0.85 - 0.98);
constexpr float INV_GAMMA = F32(1.0 / 2.2);

struct PostArgs {
    // the HDR and packed G-buffer views: [(band_h + 2 * halo) * width]
    // rows, top halo first; the history (accumulation) view
    // [(h_band_h + 2 * h_halo) * h_width] rows. Each with its row stride
    // in elements; columns are adjacent.
    const float* hdr;
    const float* gb;
    const float* accum;
    const int64_t* frame;              // the 0-dim counter, or null
    float* ldr;                        // [band_h * width, 3]
    float* out;                        // [band_h * width, 3]
    int64_t hdr_s, gb_s, accum_s;
    int64_t frame_value;               // the counter where `frame` is null
    int width, height, band_h, y0, halo;
    int h_y0, h_band_h, h_halo, h_width, h_height;
    // the packed G-buffer's first columns of position, oct normal, albedo
    // and motion (ops/gbuffer.py: GB_POS, GB_OCT, GB_ALBEDO, GB_MOTION)
    int gb_pos, gb_oct, gb_albedo, gb_motion;
    int blocks_x;                      // set by tpurt_post
    float w_spatial[TAPS];             // the bilateral's spatial weights
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

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.clamp(x, min=lo): NaN stays; else ::max on the card, and on the
// host the CPU kernel's `lo > x ? lo : x`
__device__ __forceinline__ float clamp_lo(float x, float lo) {
#ifdef TPURT_HOST_EMULATION
    return isnan_(x) ? x : (lo > x ? lo : x);
#else
    return isnan_(x) ? x : fmaxf(x, lo);
#endif
}
// torch.clamp(x, lo, hi) with scalar or tensor bounds: a NaN among them
// is the result
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
    if (isnan_(x)) return x;
    if (isnan_(lo)) return lo;
    if (isnan_(hi)) return hi;
#ifdef TPURT_HOST_EMULATION
    const float m = lo > x ? lo : x;
    return hi < m ? hi : m;
#else
    return fminf(fmaxf(x, lo), hi);
#endif
}
// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmaximum(float a, float b) {
    if (isnan_(a)) return a;
    if (isnan_(b)) return b;
    return a > b ? a : b;
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
__device__ __forceinline__ float vmax(V c) {
    return tmaximum(tmaximum(c.x, c.y), c.z);
}
// ops/post.py:_tonemap, reversible Reinhard-max
__device__ __forceinline__ V tonemap(V c) { return divs(c, 1.0f + vmax(c)); }
__device__ __forceinline__ V ycocg(V c) {
    return {(c.x * 0.25f + c.y * 0.5f) + c.z * 0.25f, c.x * 0.5f - c.z * 0.5f,
            (c.x * -0.25f + c.y * 0.5f) - c.z * 0.25f};
}
__device__ __forceinline__ V rgb(V c) {
    return {(c.x + c.y) - c.z, c.x + c.z, (c.x - c.y) - c.z};
}
// utils/vec3.py:oct_decode, normalized as vec3.normalize
__device__ __forceinline__ V oct_decode(float ex, float ey) {
    const float nz = (1.0f - fabsf(ex)) - fabsf(ey);
    const float t = clamp_lo(-nz, 0.0f);
    const V n = {ex + (ex >= 0.0f ? -t : t), ey + (ey >= 0.0f ? -t : t), nz};
    const float len = sqrtf(clamp_lo(dot(n, n), 0.0f));
    return divs(n, clamp_lo(len, F32(1e-6)));
}
// x^20 in the order of vec3.ipow: (x^4) * (x^16)
__device__ __forceinline__ float ipow20(float x) {
    const float x2 = x * x;
    const float x4 = x2 * x2;
    const float x8 = x4 * x4;
    const float x16 = x8 * x8;
    return x4 * x16;
}
// _gauss(x2, sigma): exp(-x2 / (2 sigma^2))
__device__ __forceinline__ float gauss(float x2, float two_sigma2) {
    return expf(div_scalar(-x2, two_sigma2));
}

__device__ __forceinline__ int wrap(int i, int n) {
    const int r = i % n;
    return r < 0 ? r + n : r;
}

// One bilinear tap of the history view at global (gy, gx): where(ok,
// tonemap(row), 0), ok and the row's index as views.py:_band_index.
__device__ __forceinline__ V hist_tap(const PostArgs& a, int gy, int gx) {
    const int cover = a.h_band_h + 2 * a.h_halo;
    const int local_row = gy - a.h_y0 + a.h_halo;
    const bool ok = local_row >= 0 && local_row < cover && gy >= 0 &&
                    gy < a.h_height && gx >= 0 && gx < a.h_width;
    if (!ok) return {0.0f, 0.0f, 0.0f};
    const float* r = a.accum + (static_cast<int64_t>(local_row) * a.h_width +
                                gx) * a.accum_s;
    return tonemap({r[0], r[1], r[2]});
}

__global__ void __launch_bounds__(THREADS) post_pass(PostArgs a) {
    __shared__ float tile[T_CH][TEXELS];
    const int tid = threadIdx.x;
    const int col0 = static_cast<int>(blockIdx.x) % a.blocks_x * BW;
    const int row0 = static_cast<int>(blockIdx.x) / a.blocks_x * BH;

    // the tile: texel (ty, tx) is what the eager roll reads for the
    // block's pixel (0, 0) at offset (ty - 2, tx - 2)
    const int cover = a.band_h + 2 * a.halo;
    for (int i = tid; i < TEXELS; i += THREADS) {
        const int lr = wrap(a.halo + row0 + i / TW - RADIUS, cover);
        const int c = wrap(col0 + i % TW - RADIUS, a.width);
        const int64_t p = static_cast<int64_t>(lr) * a.width + c;
        const float* h = a.hdr + p * a.hdr_s;
        const float* g = a.gb + p * a.gb_s;
        const V n = oct_decode(g[a.gb_oct], g[a.gb_oct + 1]);
        const float texel[T_CH] = {h[0], h[1], h[2],
                                   g[a.gb_albedo], g[a.gb_albedo + 1], g[a.gb_albedo + 2],
                                   n.x, n.y, n.z,
                                   g[a.gb_pos], g[a.gb_pos + 1], g[a.gb_pos + 2]};
        for (int k = 0; k < T_CH; ++k) tile[k][i] = texel[k];
    }
    __syncthreads();

    const int x = col0 + tid % BW, y = row0 + tid / BW;
    if (x >= a.width || y >= a.band_h) return;
    const int gy = a.y0 + y;
    const int ti = (tid / BW + RADIUS) * TW + tid % BW + RADIUS;
    auto at = [&](int ch, int t) -> V {
        return {tile[ch][t], tile[ch + 1][t], tile[ch + 2][t]};
    };
    auto inside = [&](int dy, int dx) {
        return gy + dy >= 0 && gy + dy < a.height && x + dx >= 0 &&
               x + dx < a.width;
    };
    const V hdr = at(T_HDR, ti), albedo = at(T_ALBEDO, ti);
    const V normal = at(T_NORMAL, ti), pos = at(T_POS, ti);

    // 5x5 joint bilateral (post.wgsl:85-141)
    V sum_color = {0.0f, 0.0f, 0.0f};
    float sum_weight = 0.0f;
#pragma unroll
    for (int dy = -RADIUS; dy <= RADIUS; ++dy) {
#pragma unroll
        for (int dx = -RADIUS; dx <= RADIUS; ++dx) {
            const int t = ti + dy * TW + dx;
            const V dc = sub(at(T_ALBEDO, t), albedo);
            const float w_color = gauss(dot(dc, dc), TWO_SIGMA_COLOR2);
            const float w_normal =
                ipow20(clamp2(dot(at(T_NORMAL, t), normal), 0.0f, 1.0f));
            const V dp = sub(at(T_POS, t), pos);
            const float w_pos = gauss(dot(dp, dp), TWO_SIGMA_POS2);
            const float w_spatial =
                a.w_spatial[(dy + RADIUS) * (2 * RADIUS + 1) + dx + RADIUS];
            const float w = w_color * w_spatial * w_normal * w_pos *
                            (inside(dy, dx) ? 1.0f : 0.0f);
            sum_color = add(sum_color, mul(at(T_HDR, t), w));
            sum_weight = sum_weight + w;
        }
    }
    const V filtered = sum_weight > F32(1e-3)
                           ? divs(sum_color, clamp_lo(sum_weight, F32(1e-3)))
                           : hdr;
    const V tm_filtered = tonemap(filtered);

    // history reprojection (post.wgsl:180-228), the motion from the
    // pixel's own packed row
    const float* mv = a.gb + (static_cast<int64_t>(a.halo + y) * a.width + x) *
                                 a.gb_s + a.gb_motion;
    const float motion_x = mv[0], motion_y = mv[1];
    const float fw = F32(a.width), fh = F32(a.height);
    const float uv_x = div_scalar(F32(x) + 0.5f, fw) + motion_x;
    const float uv_y = div_scalar(F32(y) + F32(a.y0) + 0.5f, fh) + motion_y;
    const float frame =
        F32(a.frame != nullptr ? *a.frame : a.frame_value);
    const bool hist_valid = uv_x >= 0.0f && uv_x <= 1.0f && uv_y >= 0.0f &&
                            uv_y <= 1.0f && frame > 0.0f;

    V final_tm = tm_filtered;
    if (hist_valid) {
        const float px = uv_x * fw - 0.5f;
        const float py = uv_y * fh - 0.5f;
        const int x0 = static_cast<int>(floorf(px));
        const int y0 = static_cast<int>(floorf(py));
        const float fx = px - F32(x0);
        const float fy = py - F32(y0);
        const V top = add(mul(hist_tap(a, y0, x0), 1.0f - fx),
                          mul(hist_tap(a, y0, x0 + 1), fx));
        const V bot = add(mul(hist_tap(a, y0 + 1, x0), 1.0f - fx),
                          mul(hist_tap(a, y0 + 1, x0 + 1), fx));
        const V hist_tm = add(mul(top, 1.0f - fy), mul(bot, fy));

        const float mpx = motion_x * fw, mpy = motion_y * fh;
        const float speed = sqrtf(mpx * mpx + mpy * mpy);
        if (speed < 0.5f) {
            // static: progressive average with raw history
            // (post.wgsl:246-259), the blend an f32 scalar
            const float blend = clamp2(1.0f - 1.0f / (frame + 1.0f), 0.0f, 1.0f);
            final_tm = add(mul(tm_filtered, 1.0f - blend), mul(hist_tm, blend));
        } else {
            // 3x3 YCoCg variance bounds (post.wgsl:143-177)
            V m1 = {0.0f, 0.0f, 0.0f}, m2 = {0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
                for (int dx = -1; dx <= 1; ++dx) {
                    const V c = inside(dy, dx) ? at(T_HDR, ti + dy * TW + dx)
                                               : filtered;
                    const V s = ycocg(tonemap(c));
                    m1 = add(m1, s);
                    m2 = add(m2, mul(s, s));
                }
            }
            m1 = mul(m1, NINTH);
            m2 = mul(m2, NINTH);
            const V sigma = {sqrtf(clamp_lo(m2.x - m1.x * m1.x, 0.0f)),
                             sqrtf(clamp_lo(m2.y - m1.y * m1.y, 0.0f)),
                             sqrtf(clamp_lo(m2.z - m1.z * m1.z, 0.0f))};
            const V c_min = sub(m1, mul(sigma, VARIANCE_GAMMA));
            const V c_max = add(m1, mul(sigma, VARIANCE_GAMMA));
            // clamped history with dynamic feedback (post.wgsl:235-266)
            const V h = ycocg(hist_tm);
            const V clipped = rgb({clamp2(h.x, c_min.x, c_max.x),
                                   clamp2(h.y, c_min.y, c_max.y),
                                   clamp2(h.z, c_min.z, c_max.z)});
            const float t = clamp2(div_scalar(speed, 2.0f), 0.0f, 1.0f);
            const float feedback =
                FEEDBACK_HI + (t * t * (3.0f - t * 2.0f)) * FEEDBACK_SPAN;
            final_tm = add(mul(tm_filtered, 1.0f - feedback),
                           mul(clipped, feedback));
        }
    }

    // inverse tonemap into the accumulation rows, gamma 2.2 for display
    const float d = clamp_lo(1.0f - vmax(final_tm), F32(1e-4));
    const V fin = {clamp_lo(final_tm.x / d, 0.0f), clamp_lo(final_tm.y / d, 0.0f),
                   clamp_lo(final_tm.z / d, 0.0f)};
    const int64_t o = (static_cast<int64_t>(y) * a.width + x) * 3;
    a.out[o] = fin.x;
    a.out[o + 1] = fin.y;
    a.out[o + 2] = fin.z;
    a.ldr[o] = powf(clamp2(fin.x, 0.0f, 1.0f), INV_GAMMA);
    a.ldr[o + 1] = powf(clamp2(fin.y, 0.0f, 1.0f), INV_GAMMA);
    a.ldr[o + 2] = powf(clamp2(fin.z, 0.0f, 1.0f), INV_GAMMA);
}

}  // namespace

extern "C" {

// The post pass of one band, given a PostArgs (ops/post.py: PostArgs,
// run_k10): one block a 32 x 8 tile of the band's pixels. Returns
// cudaGetLastError() after the launch.
int tpurt_post(const void* args, void* stream) {
    PostArgs a = *static_cast<const PostArgs*>(args);
    if (a.width <= 0 || a.band_h <= 0) return cudaErrorInvalidValue;
    a.blocks_x = (a.width + BW - 1) / BW;
    const int blocks = a.blocks_x * ((a.band_h + BH - 1) / BH);
    post_pass<<<dim3(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// The blocks of K10 an SM holds at once, into *blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); returns its error.
int tpurt_post_occupancy(int* blocks) {
#ifdef TPURT_HOST_EMULATION
    *blocks = 0;
    return cudaErrorInvalidValue;
#else
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, post_pass, THREADS, 0));
#endif
}

}  // extern "C"
