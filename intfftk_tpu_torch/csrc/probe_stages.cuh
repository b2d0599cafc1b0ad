// probe_stages.cuh -- the kernels of the per-stage probe as templates
// (stage_loop_kernel, stage_once_kernel), the two maps of its tile, and the
// table entry of one instantiation.  probe_stages.cu says what the probe
// replaces, computes and is bounded by, and holds the C interface;
// probe_stages_steps.cu instantiates the round-trip and register steps,
// probe_stages_groups.cu the group steps, each once for every thread count
// per CTA the library holds, so that the build compiles them side by side.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "stage_body.cuh"

namespace intfft {

// One instantiation: (step, order, 1 on the int64 tile, tile layout) and
// its two kernels.  All share one parameter list, so one launch function
// serves.
struct StepKernels {
  int step, order, wide, layout;
  const void *loop, *once;
};

// The instantiations at T threads per CTA: the round-trip and register
// steps (probe_stages_steps.cu) and the group steps
// (probe_stages_groups.cu), each compiled once per count the library
// holds (INTFFT_PROBE_THREADS); *count receives the entries.
#define INTFFT_PROBE_TABLES(T)                                                \
  const StepKernels* probe_round_steps_t##T(int* count);                      \
  const StepKernels* probe_group_steps_t##T(int* count)
INTFFT_PROBE_TABLES(128);
INTFFT_PROBE_TABLES(256);
INTFFT_PROBE_TABLES(512);
INTFFT_PROBE_TABLES(1024);

// The tile layouts: the pass's (rows padded to tc + 1 words, PaddedTile of
// stage_body.cuh) and the swizzled one (SwizzledTile below).
enum TileLayout : int { kLayoutPass = 0, kLayoutSwizzle = 1 };

// The swizzled layout packs rows at a pitch of tc elements and moves
// element e = r * tc + c within its 128-byte line L = e / W (W = 128 /
// word bytes elements) to e ^ (S(L mod 8) << log2 tc) ^ (L mod tc): the
// first term spreads the G = W / tc rows that share a line over the line's
// G slots by the line's index, the second the column within the row.
// S(l) is the XOR of v0 = G - 1, v1 = max(G / 4, 1) mod G and v2 = G / 2
// over the set bits of l.  A warp access of any step reaches rows that
// differ in at most the low bits that its G lanes' tasks and the step's
// stride set; of those, the ones above the slot bits are the low three
// bits of L, and v0, v1, v2 send every such set of rows to distinct slots
// (tools/probe_stages.py holds the model that checks it, access by access,
// for every step at every tile of the rule's range).  The rule's range: tc
// a power of two from W / 8 to W (4 to 32 on the int32 tile, 2 to 16 on
// the int64 tile).  swizzle_table packs S(0) .. S(7) as nibbles.
__host__ __device__ inline bool swizzle_ok(int tc, int word) {
  const int w = 128 / word;
  return tc >= 1 && (tc & (tc - 1)) == 0 && tc <= w && tc * 8 >= w;
}
__host__ __device__ inline int swizzle_table(int tc, int word) {
  const int g = 128 / word / tc;
  const int v[3] = {g - 1, (g >> 2 > 1 ? g >> 2 : 1) & (g - 1), g >> 1};
  int table = 0;
  for (int l = 0; l < 8; ++l) {
    int s = 0;
    for (int b = 0; b < 3; ++b) s ^= (l >> b) & 1 ? v[b] : 0;
    table |= s << (4 * l);
  }
  return table;
}

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

// The swizzled map of the [rows, tc] tile (kLayoutSwizzle; see
// swizzle_table): rows packed at a pitch of tc elements of V, each
// element moved within its 128-byte line.  The move depends on the bits
// of the line index below max(8, tc), so rows 2^lpr apart (lpr: log2 of
// W x max(8, tc) / tc) move alike: with kStrided, the form a step takes
// where the rows it pairs, or a group's rows base + (a << lo), lie a
// multiple of that apart (rows_apart), the map is spent once on the first
// row and the others are a stride of ld = tc per row away, as on the
// pass's padded tile.
template <typename V, bool kStrided = false>
struct SwizzledTile {
  static constexpr bool kAffine = kStrided;
  static constexpr int kLogLine = sizeof(V) == 4 ? 5 : 4;  // log2 W
  int lt, tcm, swz, lpr, ld;
  SwizzledTile() = default;
  __device__ __forceinline__ SwizzledTile(const PassParams& p, int table)
      : lt(p.log_tc),
        tcm(p.tc - 1),
        swz(table),
        lpr(kLogLine - p.log_tc + (p.log_tc > 3 ? p.log_tc : 3)),
        ld(p.tc) {}
  __device__ __forceinline__ int operator()(int r, int c) const {
    const int e = (r << lt) | c;
    const int l = e >> kLogLine;
    return e ^ (((swz >> ((l & 7) << 2)) & 15) << lt) ^ (l & tcm);
  }
  __device__ __forceinline__ void pair(int r, int c, int h, int& i,
                                       int& j) const {
    i = (*this)(r, c);
    j = kStrided ? i + h * ld : (*this)(r + h, c);
  }
  __device__ __forceinline__ SwizzledTile<V, true> strided() const {
    SwizzledTile<V, true> s;
    s.lt = lt, s.tcm = tcm, s.swz = swz, s.lpr = lpr, s.ld = ld;
    return s;
  }
};

// f(map) for a step whose rows lie 2^q apart: on a swizzled tile whose
// rows that far apart move alike, f gets its strided form (one loop or the
// other, chosen once per application, so neither carries the other's
// address math); any other map as it is.
template <typename Tile, typename F>
__device__ __forceinline__ void rows_apart(const Tile& at, int q, F&& f) {
  if constexpr (Tile::kAffine) {
    f(at);
  } else {
    if (q >= at.lpr) {
      f(at.strided());
    } else {
      f(at);
    }
  }
}

template <int LAYOUT, typename V>
using TileOf =
    typename std::conditional<LAYOUT == intfft::kLayoutPass, PaddedTile,
                              SwizzledTile<V>>::type;

template <int LAYOUT, typename V>
__device__ __forceinline__ TileOf<LAYOUT, V> make_tile(const PassParams& p,
                                                       int swz) {
  if constexpr (LAYOUT == intfft::kLayoutPass) {
    return PaddedTile(p);
  } else {
    return SwizzledTile<V>(p, swz);
  }
}

// One application of a shared-memory step to the whole tile, without the
// barrier that follows it.  `at` maps the tile; s_w: the order's twiddles
// staged after the two planes (kTwSmem).
template <int STEP, int P, typename V, int kT, typename Tile>
__device__ __forceinline__ void apply_step(const Tile& at, V* s_re, V* s_im,
                                           const PassParams& p, int c0,
                                           int in_w,
                                           const int32_t* __restrict__ w_re,
                                           const int32_t* __restrict__ w_im,
                                           const int32_t* __restrict__ e_re,
                                           const int32_t* __restrict__ e_im,
                                           const int32_t* s_w) {
  const int tc = p.tc, tile = p.rows * tc;
  if constexpr (STEP == kProd) {
    const int out_w = in_w + 1 - p.scale;
    rows_apart(at, P, [&](const auto& m) {
      for (int u = threadIdx.x; u < (tile >> 1); u += kT) {
        stage_body<V, false, false>(m, s_re, s_im, u, P, 1 << P, in_w, out_w,
                                    p, c0, w_re, w_im, nullptr, nullptr);
      }
    });
  } else if constexpr (STEP == kProdUnscaled || STEP == kProdRound) {
    // the mode as constants: the compiler drops bfly's other arms
    PassParams fixed = p;
    fixed.scale = STEP == kProdRound;
    fixed.round = STEP == kProdRound;
    const int out_w = in_w + 1 - fixed.scale;
    rows_apart(at, P, [&](const auto& m) {
      for (int u = threadIdx.x; u < (tile >> 1); u += kT) {
        stage_body<V, false, false>(m, s_re, s_im, u, P, 1 << P, in_w, out_w,
                                    fixed, c0, w_re, w_im, nullptr, nullptr);
      }
    });
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
    rows_apart(at, lo, [&](const auto& m) {
      for (int u = threadIdx.x; u < tasks; u += kT) {
        group_on_tile<V, false, false, GR, (lo < 2 ? lo : 2)>(
            m, s_re, s_im, u, lo, in_w, mode, c0, w_re, w_im, nullptr,
            nullptr);
      }
    });
  } else if constexpr (STEP == kTwSmem) {
    static_assert(P >= 2, "orders 0 and 1 read no twiddle");
    constexpr int h = 1 << P;
    const int32_t* s_wi = s_w + h;
    const int out_w = in_w + 1 - p.scale;
    rows_apart(at, P, [&](const auto& m) {
      for (int u = threadIdx.x; u < (tile >> 1); u += kT) {
        const int c = u & (tc - 1), t = u >> p.log_tc;
        const int k = t & (h - 1);
        int i, j;
        m.pair(((t >> P) << (P + 1)) | k, c, h, i, j);
        V sr, si, yr, yi, dr, di;
        bfly(s_re[i], s_re[j], in_w, p.scale, p.round, sr, yr);
        bfly(s_im[i], s_im[j], in_w, p.scale, p.round, si, yi);
        cmult(yr, yi, s_w[k], s_wi[k], p.tw_shift, out_w, dr, di);
        s_re[i] = sr;
        s_im[i] = si;
        s_re[j] = dr;
        s_im[j] = di;
      }
    });
  } else if constexpr (STEP == kSmem) {
    constexpr int h = 1 << P;
    rows_apart(at, P, [&](const auto& m) {
      for (int u = threadIdx.x; u < (tile >> 1); u += kT) {
        const int c = u & (tc - 1), t = u >> p.log_tc;
        const int k = t & (h - 1);
        int i, j;
        m.pair(((t >> P) << (P + 1)) | k, c, h, i, j);
        const V ar = s_re[i], ai = s_im[i], br = s_re[j], bi = s_im[j];
        s_re[i] = br;
        s_im[i] = bi;
        s_re[j] = ar;
        s_im[j] = ai;
      }
    });
  } else if constexpr (STEP == kEpi) {
    for (int u = threadIdx.x; u < tile; u += kT) {
      const int k = u >> p.log_tc, c = u & (tc - 1);
      const int a = at(k, c);
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
    for (int unit = warp; unit < units; unit += kT / 32) {
      const int r = ((unit & ((1 << log_rb) - 1)) << 5) | lane;
      const int a = at(r, unit >> log_rb);
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

// The elements of one plane of the tile: rows padded to tc + 1 (the
// pass's layout) or packed (the swizzled one).
__host__ __device__ inline int plane_elems(int rows, int tc, int layout) {
  return rows * (layout == intfft::kLayoutPass ? tc + 1 : tc);
}

// y = STEP^k(x) on this CTA's [rows, tc] tile of the [rows, cols] planes,
// with kT threads, the tile laid out as LAYOUT (swz: its swizzle_table).
template <int STEP, int P, typename V, int kT, int LAYOUT>
__device__ __forceinline__ void run_tile(const V* __restrict__ x_re,
                                         const V* __restrict__ x_im,
                                         V* __restrict__ y_re,
                                         V* __restrict__ y_im,
                                         const int32_t* __restrict__ w_re,
                                         const int32_t* __restrict__ w_im,
                                         const int32_t* __restrict__ e_re,
                                         const int32_t* __restrict__ e_im,
                                         const PassParams& p, int k,
                                         int swz) {
  const int m = p.rows, tc = p.tc;
  const int c0 = blockIdx.x * tc;
  const int tile = m * tc;
  if constexpr (STEP == kArith6 || STEP == kArith12) {
    for (int base = threadIdx.x; base < tile; base += kT * kIlp) {
      uint32_t cr[kIlp], ci[kIlp];
      size_t g[kIlp];
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        const int u = base + j * kT;
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
    const auto at = make_tile<LAYOUT, V>(p, swz);
    const int plane = plane_elems(m, tc, LAYOUT);
    V* const s_re = reinterpret_cast<V*>(smem_raw);
    V* const s_im = s_re + plane;
    // the staged twiddles of kTwSmem lie after the two planes
    int32_t* const s_w = reinterpret_cast<int32_t*>(s_im + plane);
    for (int u = threadIdx.x; u < tile; u += kT) {
      const int r = u >> p.log_tc, c = u & (tc - 1);
      const size_t g = static_cast<size_t>(r) * p.cols + c0 + c;
      const int a = at(r, c);
      s_re[a] = x_re[g];
      s_im[a] = x_im[g];
    }
    if constexpr (STEP == kTwSmem) {
      for (int u = threadIdx.x; u < (1 << P); u += kT) {
        s_w[u] = __ldg(w_re + (1 << P) + u);
        s_w[(1 << P) + u] = __ldg(w_im + (1 << P) + u);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < k; ++i) {
      apply_step<STEP, P, V, kT>(
          at, s_re, s_im, p, c0,
          p.data_width + i * step_stages(STEP) * (1 - p.scale), w_re, w_im,
          e_re, e_im, s_w);
      __syncthreads();
    }
    for (int u = threadIdx.x; u < tile; u += kT) {
      const int r = u >> p.log_tc, c = u & (tc - 1);
      const size_t g = static_cast<size_t>(r) * p.cols + c0 + c;
      const int a = at(r, c);
      y_re[g] = s_re[a];
      y_im[g] = s_im[a];
    }
  }
}

#define STAGE_KERNEL_PARAMS                                                   \
  const V *__restrict__ x_re, const V *__restrict__ x_im,                     \
      V *__restrict__ y_re, V *__restrict__ y_im,                             \
      const int32_t *__restrict__ w_re, const int32_t *__restrict__ w_im,     \
      const int32_t *__restrict__ e_re, const int32_t *__restrict__ e_im,     \
      const PassParams p, int k, int swz

template <int STEP, int P, typename V, int kT, int LAYOUT>
__global__ void __launch_bounds__(kT)
stage_loop_kernel(STAGE_KERNEL_PARAMS) {
  run_tile<STEP, P, V, kT, LAYOUT>(x_re, x_im, y_re, y_im, w_re, w_im, e_re,
                                   e_im, p, k, swz);
}

// one application; k is not read
template <int STEP, int P, typename V, int kT, int LAYOUT>
__global__ void __launch_bounds__(kT)
stage_once_kernel(STAGE_KERNEL_PARAMS) {
  run_tile<STEP, P, V, kT, LAYOUT>(x_re, x_im, y_re, y_im, w_re, w_im, e_re,
                                   e_im, p, 1, swz);
}

// The entries of one step at kT threads: (S, P, W, V) on both layouts.
#define STEP_KERNELS_AT(S, P, W, V, T, L)                                     \
  {S, P, W, L,                                                                \
   reinterpret_cast<const void*>(&stage_loop_kernel<S, P, V, T, L>),          \
   reinterpret_cast<const void*>(&stage_once_kernel<S, P, V, T, L>)}
#define STEP_KERNELS(S, P, W, V, T)                                           \
  STEP_KERNELS_AT(S, P, W, V, T, intfft::kLayoutPass),                        \
      STEP_KERNELS_AT(S, P, W, V, T, intfft::kLayoutSwizzle)

}  // namespace
