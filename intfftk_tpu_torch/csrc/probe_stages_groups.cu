// probe_stages_groups.cu -- the group steps of the per-stage probe: the
// instantiations of stage_loop_kernel / stage_once_kernel (probe_stages.cuh)
// that apply stage_group of stage_body.cuh, the function the factor pass
// runs its stages with, on the int32 and the int64 tile.  A source of its
// own so that the build compiles it beside probe_stages.cu, which holds the
// C interface and says what the probe replaces and what bounds it.

#include "probe_stages.cuh"

namespace intfft {

const StepKernels kGroupSteps[] = {
    STEP_KERNELS(kGroup3, 7, 0, int32_t),  STEP_KERNELS(kGroup3, 4, 0, int32_t),
    STEP_KERNELS(kGroup3, 3, 0, int32_t),  STEP_KERNELS(kGroup3, 2, 0, int32_t),
    STEP_KERNELS(kGroup2, 1, 0, int32_t),  STEP_KERNELS(kGroup1, 0, 0, int32_t),
    STEP_KERNELS(kGroup2, 7, 0, int32_t),
    STEP_KERNELS(kGroupUnscaled3, 7, 0, int32_t),
    STEP_KERNELS(kGroupRound3, 7, 0, int32_t),
    STEP_KERNELS(kGroupUnscaled2, 1, 0, int32_t),
    STEP_KERNELS(kGroupRound2, 1, 0, int32_t),
    STEP_KERNELS(kGroup3, 7, 1, int64_t),  STEP_KERNELS(kGroup2, 7, 1, int64_t),
    STEP_KERNELS(kGroup3, 2, 1, int64_t),  STEP_KERNELS(kGroup2, 1, 1, int64_t),
};
const int kGroupStepCount = sizeof(kGroupSteps) / sizeof(kGroupSteps[0]);

}  // namespace intfft
