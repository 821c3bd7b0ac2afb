// Row gather from a small table, for Hopper (sm_90a).
//
//   K7  tpurt_table_gather  replaces tpu_raytracer/ops/pallas_gather.py
//       `_gather_kernel` (:51) and its wrapper `table_gather` (:77):
//       out[c, r] = table[c, idx[r]], [C, R] with the ray axis minor.
//
// The port keeps its tables in the builder's [M, C] layout (one row per
// triangle, instance, material or light), so K7 reads row idx[r] of that
// layout: out[c, r] = table[clamp(idx[r], 0, M - 1), c], the reference's
// function on the transposed table. Words are copied as 32-bit patterns,
// so integer columns stored as their bits come through unchanged. The
// index is clamped as the reference clamps it (:86-87), here to the
// table's own rows; callers clamp before they call.
//
// What bounds it: bytes. Each ray reads its index once and writes C words;
// the table (at most the knot's tri_table, 100,864 x 35 x 4 B = 14 MB) is
// read from device memory about once and then from L2. There is no
// arithmetic to speak of.
// What the design does about it: one thread per ray loads and clamps its
// index once and copies its row column by column through the read-only
// path; for each column a warp stores 32 neighbouring words of one [R]
// output row, so every store is coalesced. Rows are not staged in shared
// memory: L2 holds every table the port gathers from. Offsets are 64-bit
// (a 3840 x 2160 frame gathers 8,294,400 rows of 35 words).
// The TPU kernel's loop over 128-entry table blocks with a select-merge
// (:56-71) works around `tpu.dynamic_gather`, which gathers only within
// one 128-lane vreg; a GPU thread loads any address, so it is not carried
// over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;      // rays per block

__global__ void __launch_bounds__(BLOCK)
gather_kernel(const uint32_t* __restrict__ table,
              const int32_t* __restrict__ idx, int M, int C, int R,
              uint32_t* __restrict__ out) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
    if (r >= R) return;
    int i = __ldg(idx + r);
    i = i < 0 ? 0 : (i >= M ? M - 1 : i);
    const uint32_t* row = table + static_cast<int64_t>(i) * C;
    for (int c = 0; c < C; ++c) {
        out[static_cast<int64_t>(c) * R + r] = __ldg(row + c);
    }
}

}  // namespace

extern "C" {

// table [M, C] 32-bit words, row-major; idx [R] i32; out [C, R]. M >= 1.
// Launches nothing for R = 0 or C = 0. Returns cudaGetLastError() after
// the launch.
int tpurt_table_gather(const void* table, const void* idx, int M, int C,
                       int R, void* out, void* stream) {
    if (R > 0 && C > 0) {
        const dim3 grid((R + BLOCK - 1) / BLOCK);
        gather_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint32_t*>(table),
            static_cast<const int32_t*>(idx), M, C, R,
            static_cast<uint32_t*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
