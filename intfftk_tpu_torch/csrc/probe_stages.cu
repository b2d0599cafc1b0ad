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
// data_width + i * (1 - scale), as stage i of a pass does.  The steps:
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
//     through the read-only cache for every butterfly.
//
// What bounds them: by construction the integer and shared-memory work of
// k applications (load and store are 2 x 8 bytes per sample against k
// stages, and cancel in the difference of two k).  What the design does
// about the compiler: inputs come from memory and differ per thread, the
// result is stored, the k loop is "#pragma unroll 1" and k is a kernel
// argument, so nothing folds across applications; tools/audit_sass.py
// prints each loop's instruction count beside its time.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_body.cuh"

namespace {

// the steps, in the order of STEPS in the wrapper's module
enum Step : int {
  kProd = 0,
  kShfl = 1,
  kArith6 = 2,
  kArith12 = 3,
  kSmem = 4,
  kEpi = 5,
  kProdUnscaled = 6,
  kProdRound = 7,
  kTwSmem = 8,
};

// samples a thread of a register step holds at a time
constexpr int kIlp = 8;

__device__ __forceinline__ uint32_t sra(uint32_t u, int s) {
  return static_cast<uint32_t>(static_cast<int32_t>(u) >> s);
}

// One application of a shared-memory step to the whole tile, without the
// barrier that follows it.
template <int STEP, int P, typename V>
__device__ __forceinline__ void apply_step(V* s_re, V* s_im,
                                           const PassParams& p, int c0,
                                           int in_w,
                                           const int32_t* __restrict__ w_re,
                                           const int32_t* __restrict__ w_im,
                                           const int32_t* __restrict__ e_re,
                                           const int32_t* __restrict__ e_im) {
  const int tc = p.tc, ld = tc + 1, tile = p.rows * tc;
  if constexpr (STEP == kProd) {
    const int out_w = in_w + 1 - p.scale;
    for (int u = threadIdx.x; u < (tile >> 1); u += kThreads) {
      stage_body<V, false, false>(s_re, s_im, u, P, 1 << P, in_w, out_w, p,
                                  c0, w_re, w_im, nullptr, nullptr);
    }
  } else if constexpr (STEP == kProdUnscaled || STEP == kProdRound) {
    // the mode as constants: the compiler drops bfly's other arms
    PassParams fixed = p;
    fixed.scale = STEP == kProdRound;
    fixed.round = STEP == kProdRound;
    const int out_w = in_w + 1 - fixed.scale;
    for (int u = threadIdx.x; u < (tile >> 1); u += kThreads) {
      stage_body<V, false, false>(s_re, s_im, u, P, 1 << P, in_w, out_w,
                                  fixed, c0, w_re, w_im, nullptr, nullptr);
    }
  } else if constexpr (STEP == kTwSmem) {
    static_assert(P >= 2, "orders 0 and 1 read no twiddle");
    constexpr int h = 1 << P;
    // the staged twiddles lie after the two planes (run_tile fills them)
    const int32_t* s_wr =
        reinterpret_cast<const int32_t*>(s_im + p.rows * ld);
    const int32_t* s_wi = s_wr + h;
    const int out_w = in_w + 1 - p.scale;
    for (int u = threadIdx.x; u < (tile >> 1); u += kThreads) {
      const int c = u & (tc - 1), t = u >> p.log_tc;
      const int k = t & (h - 1);
      const int i = (((t >> P) << (P + 1)) | k) * ld + c;
      const int j = i + h * ld;
      V sr, si, yr, yi, dr, di;
      bfly(s_re[i], s_re[j], in_w, p.scale, p.round, sr, yr);
      bfly(s_im[i], s_im[j], in_w, p.scale, p.round, si, yi);
      cmult(yr, yi, s_wr[k], s_wi[k], p.tw_shift, out_w, dr, di);
      s_re[i] = sr;
      s_im[i] = si;
      s_re[j] = dr;
      s_im[j] = di;
    }
  } else if constexpr (STEP == kSmem) {
    constexpr int h = 1 << P;
    for (int u = threadIdx.x; u < (tile >> 1); u += kThreads) {
      const int c = u & (tc - 1), t = u >> p.log_tc;
      const int k = t & (h - 1);
      const int i = (((t >> P) << (P + 1)) | k) * ld + c;
      const int j = i + h * ld;
      const V ar = s_re[i], ai = s_im[i], br = s_re[j], bi = s_im[j];
      s_re[i] = br;
      s_im[i] = bi;
      s_re[j] = ar;
      s_im[j] = ai;
    }
  } else if constexpr (STEP == kEpi) {
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int k = u >> p.log_tc, c = u & (tc - 1);
      const int a = k * ld + c;
      V yr, yi;
      cmult(s_re[a], s_im[a], __ldg(e_re + u), __ldg(e_im + u), p.tw_shift,
            p.data_width, yr, yi);
      s_re[a] = yr;
      s_im[a] = yi;
    }
  } else {
    static_assert(STEP == kShfl && P <= 4 && sizeof(V) == 4,
                  "the shuffle step exchanges int32 rows within a warp");
    constexpr int h = 1 << P;
    const int out_w = in_w + 1 - p.scale;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // a unit is 32 consecutive rows of one column: row block rb, column c
    const int log_rb = p.log_rows - 5;
    const int units = tile >> 5;
    for (int unit = warp; unit < units; unit += kThreads / 32) {
      const int r = ((unit & ((1 << log_rb) - 1)) << 5) | lane;
      const int a = r * ld + (unit >> log_rb);
      const V xr = s_re[a], xi = s_im[a];
      const V qr = __shfl_xor_sync(0xFFFFFFFFu, xr, h);
      const V qi = __shfl_xor_sync(0xFFFFFFFFu, xi, h);
      const bool low = (r & h) == 0;
      V sr, si, yr, yi;
      bfly(low ? xr : qr, low ? qr : xr, in_w, p.scale, p.round, sr, yr);
      bfly(low ? xi : qi, low ? qi : xi, in_w, p.scale, p.round, si, yi);
      V dr = yr, di = yi;
      const int k = r & (h - 1);
      if constexpr (P == 1) {
        if (k & 1) {
          dr = yi;
          di = neg_guarded(yr);
        }
      } else if constexpr (P > 1) {
        cmult(yr, yi, __ldg(w_re + h + k), __ldg(w_im + h + k), p.tw_shift,
              out_w, dr, di);
      }
      s_re[a] = low ? sr : dr;
      s_im[a] = low ? si : di;
    }
  }
}

// One application of a register step to one sample.
template <int STEP>
__device__ __forceinline__ void arith_step(uint32_t& xr, uint32_t& xi) {
  const uint32_t sr = sra(xr + xi + 1u, 1);
  const uint32_t si = sra(xr - xi + 1u, 1);
  if constexpr (STEP == kArith6) {
    xr = sr;
    xi = si;
  } else {
    const uint32_t pr = sra(sr * 23170u - si * 12540u, 15);
    const uint32_t pi = sra(si * 23170u + sr * 12540u, 15) + 1u;
    xr = sra(pr << 16, 16);
    xi = sra(pi << 16, 16);
  }
}

// y = STEP^k(x) on this CTA's [rows, tc] tile of the [rows, cols] planes.
template <int STEP, int P, typename V>
__device__ __forceinline__ void run_tile(const V* __restrict__ x_re,
                                         const V* __restrict__ x_im,
                                         V* __restrict__ y_re,
                                         V* __restrict__ y_im,
                                         const int32_t* __restrict__ w_re,
                                         const int32_t* __restrict__ w_im,
                                         const int32_t* __restrict__ e_re,
                                         const int32_t* __restrict__ e_im,
                                         const PassParams& p, int k) {
  const int m = p.rows, tc = p.tc, ld = tc + 1;
  const int c0 = blockIdx.x * tc;
  const int tile = m * tc;
  if constexpr (STEP == kArith6 || STEP == kArith12) {
    for (int base = threadIdx.x; base < tile; base += kThreads * kIlp) {
      uint32_t cr[kIlp], ci[kIlp];
      size_t g[kIlp];
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        const int u = base + j * kThreads;
        g[j] = static_cast<size_t>(u >> p.log_tc) * p.cols + c0 +
               (u & (tc - 1));
        cr[j] = static_cast<uint32_t>(x_re[g[j]]);
        ci[j] = static_cast<uint32_t>(x_im[g[j]]);
      }
#pragma unroll 1
      for (int i = 0; i < k; ++i) {
#pragma unroll
        for (int j = 0; j < kIlp; ++j) arith_step<STEP>(cr[j], ci[j]);
      }
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        y_re[g[j]] = static_cast<V>(static_cast<int32_t>(cr[j]));
        y_im[g[j]] = static_cast<V>(static_cast<int32_t>(ci[j]));
      }
    }
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    V* const s_re = reinterpret_cast<V*>(smem_raw);
    V* const s_im = s_re + m * ld;
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int r = u >> p.log_tc, c = u & (tc - 1);
      const size_t g = static_cast<size_t>(r) * p.cols + c0 + c;
      s_re[r * ld + c] = x_re[g];
      s_im[r * ld + c] = x_im[g];
    }
    if constexpr (STEP == kTwSmem) {
      int32_t* s_w = reinterpret_cast<int32_t*>(s_im + m * ld);
      for (int u = threadIdx.x; u < (1 << P); u += kThreads) {
        s_w[u] = __ldg(w_re + (1 << P) + u);
        s_w[(1 << P) + u] = __ldg(w_im + (1 << P) + u);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < k; ++i) {
      apply_step<STEP, P, V>(s_re, s_im, p, c0,
                             p.data_width + i * (1 - p.scale), w_re, w_im,
                             e_re, e_im);
      __syncthreads();
    }
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int r = u >> p.log_tc, c = u & (tc - 1);
      const size_t g = static_cast<size_t>(r) * p.cols + c0 + c;
      y_re[g] = s_re[r * ld + c];
      y_im[g] = s_im[r * ld + c];
    }
  }
}

#define STAGE_KERNEL_PARAMS                                                   \
  const V *__restrict__ x_re, const V *__restrict__ x_im,                     \
      V *__restrict__ y_re, V *__restrict__ y_im,                             \
      const int32_t *__restrict__ w_re, const int32_t *__restrict__ w_im,     \
      const int32_t *__restrict__ e_re, const int32_t *__restrict__ e_im,     \
      const PassParams p, int k

template <int STEP, int P, typename V>
__global__ void __launch_bounds__(kThreads)
stage_loop_kernel(STAGE_KERNEL_PARAMS) {
  run_tile<STEP, P, V>(x_re, x_im, y_re, y_im, w_re, w_im, e_re, e_im, p, k);
}

// one application; k is not read
template <int STEP, int P, typename V>
__global__ void __launch_bounds__(kThreads)
stage_once_kernel(STAGE_KERNEL_PARAMS) {
  run_tile<STEP, P, V>(x_re, x_im, y_re, y_im, w_re, w_im, e_re, e_im, p, 1);
}

// Every instantiation: (step, order, 1 on the int64 tile) and its two
// kernels.  All share one parameter list, so one launch function serves.
struct StepKernels {
  int step, order, wide;
  const void *loop, *once;
};

#define STEP_KERNELS(S, P, W, V)                                              \
  {S, P, W, reinterpret_cast<const void*>(&stage_loop_kernel<S, P, V>),       \
   reinterpret_cast<const void*>(&stage_once_kernel<S, P, V>)}

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
  for (const StepKernels& s : kSteps)
    if (s.step == step && s.order == order && s.wide == wide) return &s;
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
  return fit < 32 ? fit : 32;
}

size_t tile_smem(int step, int order, int rows, int tc, int wide) {
  if (step == kArith6 || step == kArith12) return 0;
  return 2u * rows * (tc + 1) * (wide ? 8u : 4u) +
         (step == kTwSmem ? (2u << order) * sizeof(int32_t) : 0u);
}

bool reads_stage_tables(int step) {
  return step == kProd || step == kShfl || step == kProdUnscaled ||
         step == kProdRound || step == kTwSmem;
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
// table (kEpi); the others may be null.  kProdUnscaled takes scale = 0,
// kProdRound scale = round = 1.  Returns a cudaError_t: 0 when the launch
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
      data_width + (1 - scale) * (once ? 1 : k) > (wide ? 64 : 32) ||
      (reads_stage_tables(step) && w_re == nullptr) ||
      (step == kProdUnscaled && scale) ||
      (step == kProdRound && !(scale && round)) ||
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
