// probe_stages_steps.cu -- the round-trip, register and variant steps of
// the per-stage probe: the instantiations of stage_loop_kernel /
// stage_once_kernel (probe_stages.cuh) at INTFFT_PROBE_THREADS threads per
// CTA, on both layouts of the tile (a register step keeps no tile, so it
// has one).  Compiled once for each thread count the library holds;
// probe_stages.cu holds the C interface and says what the probe replaces
// and what bounds it.

#include "probe_stages.cuh"

#ifndef INTFFT_PROBE_THREADS
#error "compile with -DINTFFT_PROBE_THREADS=the threads per CTA"
#endif

#define INTFFT_CAT(A, B) A##B
#define INTFFT_TABLE(NAME, T) INTFFT_CAT(NAME, T)

namespace {

constexpr int kT = INTFFT_PROBE_THREADS;

const intfft::StepKernels kSteps[] = {
    STEP_KERNELS(kProd, 0, 0, int32_t, kT),
    STEP_KERNELS(kProd, 1, 0, int32_t, kT),
    STEP_KERNELS(kProd, 2, 0, int32_t, kT),
    STEP_KERNELS(kProd, 3, 0, int32_t, kT),
    STEP_KERNELS(kProd, 4, 0, int32_t, kT),
    STEP_KERNELS(kProd, 5, 0, int32_t, kT),
    STEP_KERNELS(kProd, 7, 0, int32_t, kT),
    STEP_KERNELS(kShfl, 0, 0, int32_t, kT),
    STEP_KERNELS(kShfl, 1, 0, int32_t, kT),
    STEP_KERNELS(kShfl, 2, 0, int32_t, kT),
    STEP_KERNELS(kShfl, 3, 0, int32_t, kT),
    STEP_KERNELS(kShfl, 4, 0, int32_t, kT),
    STEP_KERNELS_AT(kArith6, 0, 0, int32_t, kT, intfft::kLayoutPass),
    STEP_KERNELS_AT(kArith12, 0, 0, int32_t, kT, intfft::kLayoutPass),
    STEP_KERNELS(kSmem, 7, 0, int32_t, kT),
    STEP_KERNELS(kEpi, 0, 0, int32_t, kT),
    STEP_KERNELS(kProd, 0, 1, int64_t, kT),
    STEP_KERNELS(kProd, 1, 1, int64_t, kT),
    STEP_KERNELS(kProd, 7, 1, int64_t, kT),
    STEP_KERNELS(kSmem, 7, 1, int64_t, kT),
    STEP_KERNELS(kEpi, 0, 1, int64_t, kT),
    STEP_KERNELS(kProdUnscaled, 0, 0, int32_t, kT),
    STEP_KERNELS(kProdUnscaled, 7, 0, int32_t, kT),
    STEP_KERNELS(kProdRound, 0, 0, int32_t, kT),
    STEP_KERNELS(kProdRound, 7, 0, int32_t, kT),
    STEP_KERNELS(kTwSmem, 7, 0, int32_t, kT),
};

}  // namespace

namespace intfft {

const StepKernels* INTFFT_TABLE(probe_round_steps_t,
                                INTFFT_PROBE_THREADS)(int* count) {
  *count = sizeof(kSteps) / sizeof(kSteps[0]);
  return kSteps;
}

}  // namespace intfft
