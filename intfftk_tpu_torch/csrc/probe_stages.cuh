// probe_stages.cuh -- the kernels of the per-stage probe as templates
// (stage_loop_kernel, stage_once_kernel) and the table entry of one
// instantiation.  probe_stages.cu says what the probe replaces, computes
// and is bounded by, holds the C interface and instantiates the round-trip
// steps; probe_stages_groups.cu instantiates the group steps, so that the
// build compiles the two halves side by side.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_body.cuh"

namespace intfft {

// One instantiation: (step, order, 1 on the int64 tile) and its two
// kernels.  All share one parameter list, so one launch function serves.
struct StepKernels {
  int step, order, wide;
  const void *loop, *once;
};

// The group steps' instantiations (probe_stages_groups.cu).
extern const StepKernels kGroupSteps[];
extern const int kGroupStepCount;

}  // namespace intfft

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
  // stage_group of stage_body.cuh through one exchange of the tile: R
  // stages from the top order P down, R = 1, 2, 3 ...
  kGroup1 = 9,
  kGroup2 = 10,
  kGroup3 = 11,
  // ... and with the mode fixed at compile time, as kProdUnscaled/kProdRound
  kGroupUnscaled2 = 12,
  kGroupUnscaled3 = 13,
  kGroupRound2 = 14,
  kGroupRound3 = 15,
};

__host__ __device__ constexpr bool is_group(int step) { return step >= kGroup1; }
// the stages one application of a step runs
__host__ __device__ constexpr int step_stages(int step) {
  return !is_group(step) ? 1
         : step <= kGroup3 ? step - kGroup1 + 1
                           : 2 + ((step - kGroupUnscaled2) & 1);
}
__host__ __device__ constexpr bool step_unscaled(int step) {
  return step == kProdUnscaled || step == kGroupUnscaled2 ||
         step == kGroupUnscaled3;
}
__host__ __device__ constexpr bool step_round(int step) {
  return step == kProdRound || step == kGroupRound2 || step == kGroupRound3;
}

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
  } else if constexpr (is_group(STEP)) {
    // the orders P .. P - R + 1 of every task, in registers between one
    // load and one store of the tile: the function the pass runs
    constexpr int GR = step_stages(STEP), lo = P - GR + 1;
    static_assert(lo >= 0, "a group of R stages needs a top order >= R - 1");
    PassParams mode = p;
    if constexpr (step_unscaled(STEP) || step_round(STEP)) {
      mode.scale = step_round(STEP);
      mode.round = step_round(STEP);
    }
    const int tasks = (p.rows >> GR) << p.log_tc;
    for (int u = threadIdx.x; u < tasks; u += kThreads) {
      group_on_tile<V, false, false, GR, (lo < 2 ? lo : 2)>(
          s_re, s_im, u, lo, in_w, mode, c0, w_re, w_im, nullptr, nullptr);
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
      apply_step<STEP, P, V>(
          s_re, s_im, p, c0,
          p.data_width + i * step_stages(STEP) * (1 - p.scale), w_re, w_im,
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

#define STEP_KERNELS(S, P, W, V)                                              \
  {S, P, W, reinterpret_cast<const void*>(&stage_loop_kernel<S, P, V>),       \
   reinterpret_cast<const void*>(&stage_once_kernel<S, P, V>)}

}  // namespace
