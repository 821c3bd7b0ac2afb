// Stage marks of the frame (`utils/profiling.py:stage`), for Hopper
// (sm_90a).
//
// One one-thread kernel a stage, named after it, so that a device trace
// of a replayed CUDA graph, which carries no host ranges, can tell the
// stages apart by kernel name: every operation queued on a card between
// `tpurt_mark_<stage>` and the next mark belongs to that stage, and
// `tpurt_mark_end` closes the last one. A mark reads nothing. Given a
// stamp row, it writes the device's global nanosecond timer into its
// slot, so the stamps of one replay time each stage without a profiler.
// No name ends in `_kernel`: the trace's readers of K1-K8 match that
// suffix.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int64_t global_ns() {
#ifdef TPURT_HOST_EMULATION
    return emu_globaltimer();
#else
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return static_cast<int64_t>(t);
#endif
}

#define TPURT_MARK(stage)                                                \
    __global__ void tpurt_mark_##stage(int64_t* stamps, int slot) {     \
        if (stamps != nullptr) stamps[slot] = global_ns();               \
    }

TPURT_MARK(refit)
TPURT_MARK(gbuffer)
TPURT_MARK(restir_temporal)
TPURT_MARK(path_trace)
TPURT_MARK(restir_spatial)
TPURT_MARK(post)
TPURT_MARK(state_copy)
TPURT_MARK(end)

#undef TPURT_MARK

using Mark = void (*)(int64_t*, int);

// in the order of `utils/profiling.py:STAGES`
const Mark MARKS[] = {
    tpurt_mark_refit,          tpurt_mark_gbuffer,
    tpurt_mark_restir_temporal, tpurt_mark_path_trace,
    tpurt_mark_restir_spatial, tpurt_mark_post,
    tpurt_mark_state_copy,     tpurt_mark_end,
};
constexpr int N_MARKS = sizeof(MARKS) / sizeof(MARKS[0]);

}  // namespace

extern "C" {

// Launch the mark of stage `stage` (an index into MARKS) on `stream`:
// one block of one thread. stamps: an int64 row on the stream's device,
// or null (no stamp written); slot: the mark's word of the row. Returns
// cudaErrorInvalidValue for an unknown stage, else cudaGetLastError()
// after the launch.
int tpurt_mark(int stage, void* stamps, int slot, void* stream) {
    if (stage < 0 || stage >= N_MARKS) return cudaErrorInvalidValue;
    const Mark mark = MARKS[stage];
    mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int64_t*>(stamps), slot);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
