// probe_stages_groups.cu -- the group steps of the per-stage probe: the
// instantiations of stage_loop_kernel / stage_once_kernel (probe_stages.cuh)
// that apply stage_group of stage_body.cuh, the function the factor pass
// runs its stages with, on the int32 and the int64 tile, at
// INTFFT_PROBE_THREADS threads per CTA and on both layouts of the tile.
// Compiled once for each thread count the library holds, beside
// probe_stages_steps.cu; probe_stages.cu holds the C interface and says
// what the probe replaces and what bounds it.

#include "probe_stages.cuh"

#ifndef INTFFT_PROBE_THREADS
#error "compile with -DINTFFT_PROBE_THREADS=the threads per CTA"
#endif

#define INTFFT_CAT(A, B) A##B
#define INTFFT_TABLE(NAME, T) INTFFT_CAT(NAME, T)

namespace {

constexpr int kT = INTFFT_PROBE_THREADS;

const intfft::StepKernels kGroupSteps[] = {
    STEP_KERNELS(kGroup3, 7, 0, int32_t, kT),
    STEP_KERNELS(kGroup3, 4, 0, int32_t, kT),
    STEP_KERNELS(kGroup3, 3, 0, int32_t, kT),
    STEP_KERNELS(kGroup3, 2, 0, int32_t, kT),
    STEP_KERNELS(kGroup2, 1, 0, int32_t, kT),
    STEP_KERNELS(kGroup1, 0, 0, int32_t, kT),
    STEP_KERNELS(kGroup2, 7, 0, int32_t, kT),
    STEP_KERNELS(kGroupUnscaled3, 7, 0, int32_t, kT),
    STEP_KERNELS(kGroupRound3, 7, 0, int32_t, kT),
    STEP_KERNELS(kGroupUnscaled2, 1, 0, int32_t, kT),
    STEP_KERNELS(kGroupRound2, 1, 0, int32_t, kT),
    STEP_KERNELS(kGroup3, 7, 1, int64_t, kT),
    STEP_KERNELS(kGroup2, 7, 1, int64_t, kT),
    STEP_KERNELS(kGroup3, 2, 1, int64_t, kT),
    STEP_KERNELS(kGroup2, 1, 1, int64_t, kT),
};

}  // namespace

namespace intfft {

const StepKernels* INTFFT_TABLE(probe_group_steps_t,
                                INTFFT_PROBE_THREADS)(int* count) {
  *count = sizeof(kGroupSteps) / sizeof(kGroupSteps[0]);
  return kGroupSteps;
}

}  // namespace intfft
