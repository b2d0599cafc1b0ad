// probe_stages.cu -- the per-stage probe of the factor pass, for Hopper
// (sm_90a): what one radix-2 stage costs on the card, by twiddle order,
// beside its arithmetic alone and its data movement alone.
//
// Replaces, on the NVIDIA H100, the two Pallas TPU measurement kernels of
// tools/probe_stages.py:
//   * _loop_kernel (:55, pallas_call at :72): step(tabs, xr, xi) applied K
//     times to an [n, B] int32 tile pair held in fast memory, so that the
//     time difference of two K is one application with load, store and
//     dispatch cancelled -> stage_loop_kernel<STEP, P, V>;
//   * _once_kernel (:87, pallas_call at :99): step applied once, to hold a
//     variant against the production stage bit for bit on the device before
//     its time is believed -> stage_once_kernel<STEP, P, V>.
//
// What they compute.  x and y are [rows, cols] planes (re, im).  One CTA
// holds an [rows, TC] tile pair in shared memory with the geometry of
// fused_pass_kernel (256 threads, TC = min(32, 65536 / (rows * sizeof V)),
// rows padded to TC + 1 words), loads it once, applies STEP k times with a
// barrier after each, as the pass's stage loop has it, and stores it once:
// y = STEP^k(x), equal to stage_loop_reference of
// intfftk_tpu_torch/tools/probe_stages.py.  Application i runs at the width
// data_width + i * (1 - scale), as stage i of a pass does (a group step: i
// times its stages).  The steps:
//   * kProd, order P: stage_body of stage_body.cuh, the function
//     fused_pass_kernel runs, at the fixed twiddle order P (forward, 1-D
//     tables): the compiler keeps the one twiddle form of that order;
//   * kShfl, order P <= 4: the same stage with a warp laid along 32 rows of
//     one column: the partner row arrives by __shfl_xor_sync, every thread
//     computes both outputs of its butterfly and keeps its own by the row's
//     parity (the image of the TPU tool's roll variant).  One shared-memory
//     load and store per element instead of two, no second operand load;
//   * kSmem, order P: the stage's four loads, four stores and barrier with no
//     arithmetic (the two rows of each butterfly change places): the floor
//     of one stage's data movement;
//   * kEpi: every element times the entry of an [rows, TC] table, the
//     inter-factor twiddle's arithmetic (cmult of intfft_arith.cuh);
//   * kArith6, kArith12: the TPU tool's op images (:224-234) on values held
//     in registers, eight samples per thread at a time, no shared memory:
//     the stage's arithmetic with no data movement;
//   * kProdUnscaled, kProdRound, order P: stage_body again, with the scale
//     and rounding mode fixed at compile time (unscaled, and scaled with
//     round half up) where the pass reads them from its parameters: what
//     the run-time mode branches of bfly cost;
//   * kTwSmem, order P >= 2: the production stage with the order's twiddles
//     staged once per CTA in shared memory, where stage_body reads each
//     through the read-only cache for every butterfly;
//   * kGroup1/2/3, top order P: stage_group of stage_body.cuh, the function
//     fused_pass_kernel runs its stages with: the R stages of the orders
//     P .. P - R + 1 on 2^R rows held in registers, between one load and one
//     store of the tile (group_on_tile); one application is R stages, and
//     application i runs at the width data_width + i * R * (1 - scale);
//   * kGroupUnscaled2/3, kGroupRound2/3: the same with the mode fixed at
//     compile time.
//
// What bounds them: by construction the integer and shared-memory work of
// k applications (load and store are 2 x 8 bytes per sample against k
// stages, and cancel in the difference of two k).  What the design does
// about the compiler: inputs come from memory and differ per thread, the
// result is stored, the k loop is "#pragma unroll 1" and k is a kernel
// argument, so nothing folds across applications; tools/audit_sass.py
// prints each loop's instruction count beside its time.

#include "probe_stages.cuh"

namespace {

using intfft::StepKernels;

// the round-trip, register and variant steps; the group steps are
// intfft::kGroupSteps of probe_stages_groups.cu
const StepKernels kSteps[] = {
    STEP_KERNELS(kProd, 0, 0, int32_t),  STEP_KERNELS(kProd, 1, 0, int32_t),
    STEP_KERNELS(kProd, 2, 0, int32_t),  STEP_KERNELS(kProd, 3, 0, int32_t),
    STEP_KERNELS(kProd, 4, 0, int32_t),  STEP_KERNELS(kProd, 5, 0, int32_t),
    STEP_KERNELS(kProd, 7, 0, int32_t),  STEP_KERNELS(kShfl, 0, 0, int32_t),
    STEP_KERNELS(kShfl, 1, 0, int32_t),  STEP_KERNELS(kShfl, 2, 0, int32_t),
    STEP_KERNELS(kShfl, 3, 0, int32_t),  STEP_KERNELS(kShfl, 4, 0, int32_t),
    STEP_KERNELS(kArith6, 0, 0, int32_t),
    STEP_KERNELS(kArith12, 0, 0, int32_t),
    STEP_KERNELS(kSmem, 7, 0, int32_t),  STEP_KERNELS(kEpi, 0, 0, int32_t),
    STEP_KERNELS(kProd, 0, 1, int64_t),  STEP_KERNELS(kProd, 1, 1, int64_t),
    STEP_KERNELS(kProd, 7, 1, int64_t),  STEP_KERNELS(kSmem, 7, 1, int64_t),
    STEP_KERNELS(kEpi, 0, 1, int64_t),
    STEP_KERNELS(kProdUnscaled, 0, 0, int32_t),
    STEP_KERNELS(kProdUnscaled, 7, 0, int32_t),
    STEP_KERNELS(kProdRound, 0, 0, int32_t),
    STEP_KERNELS(kProdRound, 7, 0, int32_t),
    STEP_KERNELS(kTwSmem, 7, 0, int32_t),
};

const StepKernels* find_step(int step, int order, int wide) {
  const auto is = [&](const StepKernels& s) {
    return s.step == step && s.order == order && s.wide == wide;
  };
  for (const StepKernels& s : kSteps)
    if (is(s)) return &s;
  for (int i = 0; i < intfft::kGroupStepCount; ++i)
    if (is(intfft::kGroupSteps[i])) return &intfft::kGroupSteps[i];
  return nullptr;
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The tile of `rows` rows on the tile type of `wide`: columns per CTA (the
// rule of fused_pass.cu's launch) and the dynamic shared memory of a step.
int tile_columns(int rows, int wide) {
  const int fit = 65536 / (rows * (wide ? 8 : 4));
  return fit < 16 ? fit : 16;
}

size_t tile_smem(int step, int order, int rows, int tc, int wide) {
  if (step == kArith6 || step == kArith12) return 0;
  return 2u * rows * (tc + 1) * (wide ? 8u : 4u) +
         (step == kTwSmem ? (2u << order) * sizeof(int32_t) : 0u);
}

bool reads_stage_tables(int step) {
  return step == kProd || step == kShfl || step == kProdUnscaled ||
         step == kProdRound || step == kTwSmem || is_group(step);
}

bool shape_ok(int step, int order, int rows) {
  const int log_rows = log2_exact(rows);
  if (log_rows < 3 || log_rows > 12) return false;
  if (step == kSmem || (reads_stage_tables(step) && step != kShfl))
    return order < log_rows;
  if (step == kShfl) return rows >= 32;
  return true;
}

}  // namespace

// Columns per CTA of a step's tile and how many of its CTAs one SM holds
// at once (the occupancy the runtime computes for stage_loop_kernel), so
// the caller can choose a width that fills the card.  wide: 1 for the int64
// tile.  Returns a cudaError_t.
extern "C" int intfft_stage_probe_geometry(int step, int order, int wide,
                                           int rows, int device, int* tc,
                                           int* ctas_per_sm) {
  const StepKernels* s = find_step(step, order, wide);
  if (s == nullptr || !shape_ok(step, order, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *tc = tile_columns(rows, wide);
  const size_t smem = tile_smem(step, order, rows, *tc, wide);
  err = cudaFuncSetAttribute(s->loop,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, s->loop, kThreads, smem));
}

// One launch: y = STEP^k(x) over [rows, cols] planes of int32 (wide: int64)
// elements, cols a multiple of the tile's columns; once: 1 launches
// stage_once_kernel (one application, k not read).  w_re/w_im: the packed
// stage tables [rows] (kProd, kShfl); e_re/e_im: an [rows, tile columns]
// table (kEpi); the others may be null.  kProdUnscaled and
// kGroupUnscaled* take scale = 0, kProdRound and kGroupRound* scale =
// round = 1.  Returns a cudaError_t: 0 when the launch
// was accepted.
extern "C" int intfft_stage_probe(const void* x_re, const void* x_im,
                                  void* y_re, void* y_im, const void* w_re,
                                  const void* w_im, const void* e_re,
                                  const void* e_im, int rows, int cols,
                                  int step, int order, int wide, int k,
                                  int once, int data_width, int scale,
                                  int round, int tw_shift, int device,
                                  void* stream) {
  const StepKernels* s = find_step(step, order, wide);
  if (s == nullptr || !shape_ok(step, order, rows) || cols < 1 || k < 0 ||
      data_width < 1 ||
      data_width + (1 - scale) * step_stages(step) * (once ? 1 : k) >
          (wide ? 64 : 32) ||
      (reads_stage_tables(step) && w_re == nullptr) ||
      (step_unscaled(step) && scale) ||
      (step_round(step) && !(scale && round)) ||
      (step == kEpi && e_re == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tc = tile_columns(rows, wide);
  if (cols % tc != 0 || (rows * tc) % (kThreads * kIlp) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  PassParams p{1, rows, cols, log2_exact(rows), tc, log2_exact(tc),
               data_width, scale, round, tw_shift, 0, 0, 0, 0};
  const size_t smem = tile_smem(step, order, rows, tc, wide);
  const void* kernel = once ? s->once : s->loop;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&x_re, &x_im, &y_re, &y_im, &w_re,
                  &w_im, &e_re, &e_im, &p,    &k};
  err = cudaLaunchKernel(kernel, dim3(cols / tc), dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
