// fused_pass.cuh -- the factor pass kernel of the integer FFT as a template
// (fused_pass_kernel), its launch, and the twiddle synthesis it shares with
// the generator kernel.  What it replaces, computes and is bounded by stands
// at the head of fused_pass.cu, which holds the C interface.
//
// The kernel is instantiated for four pairs of block types, two directions
// and (on the int32 tile) the 1-D and 2-D stage tables: twelve kernels, each
// with a body for every shape of stage group.  One source with all twelve
// compiles for 40 s on the card's machine; so fused_pass_inst.cu, which
// includes this header and defines one launch_pass_* function, is compiled
// once for each pair of block types and direction, and the build runs the
// eight compilations side by side.  What crosses from one object to another
// has external linkage (namespace intfft); everything else is internal to
// each.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_body.cuh"

namespace intfft {

// The twiddle generator's constants for the full size n = 2^log_n
// (twiddle_synth.synth_params): the Taylor pi constant of stage order
// log_n - 1, the MACC's XSHIFT, and the low address bits of the count.
struct SynthParams {
  int log_n, mathpi, xshift, sh_cnt;
};


// The pointers of one launch: stage tables (1-D w, or 2-D t2), epilogue
// (table e, or coarse table c), data in and out.
struct PassPtrs {
  const void *x_re, *x_im, *w_re, *w_im, *t2_re, *t2_im, *e_re, *e_im,
      *c_re, *c_im;
  void *y_re, *y_im;
};

// One pass in one direction on blocks of one pair of element types (x, y):
// int16 -> int16 and int32 -> int32 on the int32 tile, int32 -> int64 (the
// widening pass) and int64 -> int64 on the int64 tile; each defined by one
// compilation of fused_pass_inst.cu.  *launches counts the kernel launches
// made.
#define INTFFT_LAUNCH_PASS(NAME)                                              \
  cudaError_t NAME(const PassPtrs& a, const PassParams& p,                    \
                   const SynthParams& syn, int device, cudaStream_t stream,   \
                   int* launches)
INTFFT_LAUNCH_PASS(launch_pass_i16_fwd);
INTFFT_LAUNCH_PASS(launch_pass_i16_inv);
INTFFT_LAUNCH_PASS(launch_pass_i32_fwd);
INTFFT_LAUNCH_PASS(launch_pass_i32_inv);
INTFFT_LAUNCH_PASS(launch_pass_i32_i64_fwd);
INTFFT_LAUNCH_PASS(launch_pass_i32_i64_inv);
INTFFT_LAUNCH_PASS(launch_pass_i64_fwd);
INTFFT_LAUNCH_PASS(launch_pass_i64_inv);

}  // namespace intfft

namespace {

using intfft::PassPtrs;
using intfft::SynthParams;

constexpr int kCoarse = 512;     // entries of the coarse quarter table
constexpr int kMaxGridY = 65535; // the most items one launch takes
constexpr int kMaxDevices = 64;  // devices a process may launch on

// W_n^m for m in [0, n) from the coarse quarter table (re, im): bit-equal
// to golden circle_twiddles_int(n)[m] (synth_circle_block): the
// half-circle fold by the top bit, the quadrant fold (x -j) by the next,
// the coarse entry of the top 9 address bits, and the exact Taylor MACC
// of row_twiddle_tay.vhd, rnd((a << XS) +- b*mpx) >> XS, computed as
// 2a + floor(+-b*mpx / 2^(XS-1)) rounded half up on its LSB.  At twiddle
// widths <= 16, |b| < 2^15 and mpx < 2^15, so every product fits int32.
__device__ __forceinline__ void synth_twiddle(int m, const int32_t* cre,
                                              const int32_t* cim,
                                              const SynthParams& s,
                                              int32_t& er, int32_t& ei) {
  const int top = s.log_n - 1;
  const int neg = m >> top;
  const int mm = m & ((1 << top) - 1);
  const int div = mm >> (top - 1);
  const int addr = mm & ((1 << (top - 1)) - 1);
  const int count = addr & ((1 << s.sh_cnt) - 1);
  const int32_t re = cre[addr >> s.sh_cnt], im = cim[addr >> s.sh_cnt];
  const int32_t fre = div ? im : re;
  const int32_t fim = div ? -re : im;
  const int32_t mpx = (s.mathpi * count) >> 1;
  const int sh = s.xshift - 1;
  int32_t t = 2 * fre + ((fim * mpx) >> sh);
  const int32_t tre = (t >> 1) + (t & 1);
  t = 2 * fim + ((-(fre * mpx)) >> sh);
  const int32_t tim = (t >> 1) + (t & 1);
  er = neg ? -tre : tre;
  ei = neg ? -tim : tim;
}

// What one launch works on: the operands, the tile and what the kernel
// derives from its parameters once.
template <typename Tin, typename Tout, typename V>
struct PassCtx {
  const Tin *x_re, *x_im;
  Tout *y_re, *y_im;
  const int32_t *w_re, *w_im, *t2_re, *t2_im, *e_re, *e_im;
  const int32_t *s_cre, *s_cim;   // the coarse table, staged (synth)
  V *s_re, *s_im;                 // the tile's planes
  size_t item;                    // offset of this CTA's batch item
  int c0;                         // the tile's first global column
  int rev_sh;                     // 32 - log_rows
  bool rev_in, rev_out;           // which side is reordered
  bool synth, epilogue;           // the inter-factor product and its source
  int ow;                         // the factor's output width
  int n_full;                     // the full size the synthesis indexes
};

// One group of the pass over the whole tile: R stages (R = 0: none, the
// bypass) of the orders lo .. lo + R - 1 on every task.  The operands come
// from device memory (from_x: rows of x[b, :, col], the inverse's
// bit-reversed load an index on the row) or from the tile, and go to device
// memory (to_y: out[b, k, col], the forward's natural order an index on k)
// or to the tile.  The last group multiplies its registers by the
// inter-factor twiddle of the stored row first.  A thread whose column lies
// past p.cols loads zeros and stores nothing to device memory.
template <typename Tin, typename Tout, typename V, bool kInverse, bool kTwoD,
          int R, int kLo>
__device__ __forceinline__ void run_group(const PassCtx<Tin, Tout, V>& k,
                                          const PassParams& p,
                                          const SynthParams& syn, int lo_rt,
                                          int in_w0, bool from_x, bool to_y,
                                          bool last) {
  constexpr int N = 1 << R;
  const int lo = kLo < 2 ? kLo : lo_rt;
  const int ld = p.tc + 1;
  const int tasks = (p.rows >> R) << p.log_tc;
  for (int u = threadIdx.x; u < tasks; u += kThreads) {
    int c, k0, base;
    group_rows<R>(u, lo, p, c, k0, base);
    const int col = k.c0 + c;
    const bool live = col < p.cols;
    V xr[N], xi[N];
    if (from_x) {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const int row = base + (a << lo);
        const int src = k.rev_in ? (__brev(row) >> k.rev_sh) : row;
        xr[a] = xi[a] = 0;
        if (live) {
          const size_t g = k.item + static_cast<size_t>(src) * p.cols + col;
          xr[a] = k.x_re[g];
          xi[a] = k.x_im[g];
        }
      }
    } else {
      group_load_tile<V, R>(k.s_re, k.s_im, base * ld + c, ld << lo, xr, xi);
    }
    stage_group<V, kInverse, kTwoD, R, kLo>(xr, xi, lo, k0, in_w0, p, col,
                                            k.w_re, k.w_im, k.t2_re,
                                            k.t2_im);
    if (last && k.epilogue && live) {
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const int row = base + (a << lo);
        const int kk = k.rev_out ? (__brev(row) >> k.rev_sh) : row;
        int32_t wr, wi;
        if (k.synth) {
          // kk * col < n: the host checks the block against n
          int mi = kk * col;
          if (kInverse) mi = (k.n_full - mi) & (k.n_full - 1);
          synth_twiddle(mi, k.s_cre, k.s_cim, syn, wr, wi);
        } else {
          const size_t g = static_cast<size_t>(kk) * p.cols + col;
          wr = __ldg(k.e_re + g);
          wi = __ldg(k.e_im + g);
        }
        cmult(xr[a], xi[a], wr, wi, p.tw_shift, k.ow, xr[a], xi[a]);
      }
    }
    if (to_y) {
      if (live) {
#pragma unroll
        for (int a = 0; a < N; ++a) {
          const int row = base + (a << lo);
          const int kk = k.rev_out ? (__brev(row) >> k.rev_sh) : row;
          const size_t g = k.item + static_cast<size_t>(kk) * p.cols + col;
          k.y_re[g] = static_cast<Tout>(xr[a]);
          k.y_im[g] = static_cast<Tout>(xi[a]);
        }
      }
    } else {
      group_store_tile<V, R>(k.s_re, k.s_im, base * ld + c, ld << lo, xr,
                             xi);
    }
  }
}

// Tin / Tout: the element types of x and y; V: the tile's (int32, or
// int64 for the wide forms).  The CTAs an SM should hold bound the
// registers: four of the forward on the int32 tile (64 registers a thread,
// what the 16-column tile of m = 256 has room for), three of the inverse
// (85), two on the int64 tile (128).
template <typename Tin, typename Tout, typename V, bool kInverse, bool kTwoD>
__global__ void __launch_bounds__(kThreads, sizeof(V) == 8 ? 2
                                            : kInverse     ? 3
                                                           : 4)
fused_pass_kernel(const Tin* __restrict__ x_re, const Tin* __restrict__ x_im,
                  const int32_t* __restrict__ w_re,
                  const int32_t* __restrict__ w_im,
                  const int32_t* __restrict__ t2_re,
                  const int32_t* __restrict__ t2_im,
                  const int32_t* __restrict__ e_re,
                  const int32_t* __restrict__ e_im,
                  const int32_t* __restrict__ c_re,
                  const int32_t* __restrict__ c_im, Tout* __restrict__ y_re,
                  Tout* __restrict__ y_im, const PassParams p,
                  const SynthParams syn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = GroupSize<V>::R;
  V* const smem = reinterpret_cast<V*>(smem_raw);
  const int m = p.rows, tc = p.tc, ld = tc + 1;
  // the coarse table of the in-kernel epilogue lies after the two planes;
  // the int64 tile never synthesizes
  int32_t* const s_cre = reinterpret_cast<int32_t*>(smem + 2 * m * ld);
  PassCtx<Tin, Tout, V> k;
  k.x_re = x_re, k.x_im = x_im, k.y_re = y_re, k.y_im = y_im;
  k.w_re = w_re, k.w_im = w_im, k.t2_re = t2_re, k.t2_im = t2_im;
  k.e_re = e_re, k.e_im = e_im;
  k.s_cre = s_cre, k.s_cim = s_cre + kCoarse;
  k.s_re = smem, k.s_im = smem + m * ld;
  k.item = static_cast<size_t>(blockIdx.y) * m * p.cols;
  k.c0 = blockIdx.x * tc;
  k.rev_sh = 32 - p.log_rows;
  // which side is reordered: the inverse's load, the forward's store
  k.rev_in = kInverse && p.natural;
  k.rev_out = !kInverse && p.natural;
  k.synth = sizeof(V) == 4 && c_re != nullptr;
  k.epilogue = e_re != nullptr || k.synth;
  const int gain = 1 - p.scale;
  k.ow = p.data_width + p.log_rows * gain;
  k.n_full = 1 << syn.log_n;
  const int tile = m * tc;

  // a [B, C, R] operand is read along R into the tile: consecutive lanes
  // read consecutive addresses; the tail tile reads zeros
  if (p.transpose_in) {
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int r = u & (m - 1), c = u >> p.log_rows, col = k.c0 + c;
      V vr = 0, vi = 0;
      if (col < p.cols) {
        const size_t g = k.item + static_cast<size_t>(col) * m + r;
        vr = x_re[g];
        vi = x_im[g];
      }
      const int a = (k.rev_in ? (__brev(r) >> k.rev_sh) : r) * ld + c;
      k.s_re[a] = vr;
      k.s_im[a] = vi;
    }
  }
  if (k.synth) {
    for (int u = threadIdx.x; u < kCoarse; u += kThreads) {
      s_cre[u] = __ldg(c_re + u);
      s_cre[kCoarse + u] = __ldg(c_im + u);
    }
  }
  if (p.transpose_in || k.synth) __syncthreads();

  // the groups: forward (DIF) from the top order down, inverse (DIT) from
  // the bottom up; the bypass is one group of no stage.  The first group
  // reads x itself unless the operand is turned, the last writes y itself
  // unless the store is; between two groups the tile is exchanged once.
  const int n_groups = p.bypass ? 1 : group_count(p.log_rows, R);
  for (int i = 0; i < n_groups; ++i) {
    int q = -1, r = 0;
    if (!p.bypass) {
      group_of(p.log_rows, R, kInverse ? n_groups - 1 - i : i, q, r);
    }
    const int lo = q - r + 1;
    // the stage index of the group's first stage sets its width
    const int in_w0 =
        p.data_width + (kInverse ? lo : p.log_rows - 1 - q) * gain;
    const bool last = i == n_groups - 1;
    const bool from_x = i == 0 && !p.transpose_in;
    const bool to_y = last && !p.transpose_out;
#define RUN_GROUP(GR, GLO)                                                    \
  run_group<Tin, Tout, V, kInverse, kTwoD, GR, GLO>(k, p, syn, lo, in_w0,     \
                                                    from_x, to_y, last)
    if (r == R) {
      if (lo >= 2) {
        RUN_GROUP(R, 2);
      } else if (lo == 1) {
        RUN_GROUP(R, 1);
      } else {
        RUN_GROUP(R, 0);
      }
    } else if (r == 2) {
      if constexpr (R > 2) RUN_GROUP(2, 0);
    } else if (r == 1) {
      if constexpr (R > 1) RUN_GROUP(1, 0);
    } else {
      RUN_GROUP(0, 0);
    }
#undef RUN_GROUP
    if (!to_y) __syncthreads();
  }

  // out[b, col, k]: m contiguous values per column, read from the tile
  // along k (stored row k lives at tile row bitrev(k) in the natural
  // forward, at row k otherwise)
  if (p.transpose_out) {
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int kk = u & (m - 1), c = u >> p.log_rows, col = k.c0 + c;
      if (col < p.cols) {
        const int a = (k.rev_out ? (__brev(kk) >> k.rev_sh) : kk) * ld + c;
        const size_t g = k.item + static_cast<size_t>(col) * m + kk;
        y_re[g] = static_cast<Tout>(k.s_re[a]);
        y_im[g] = static_cast<Tout>(k.s_im[a]);
      }
    }
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

template <typename Tin, typename Tout, typename V, bool kInverse,
          bool kTwoD>
cudaError_t launch(const PassPtrs& a, PassParams p, const SynthParams& syn,
                   int device, cudaStream_t stream, int* launches) {
  // TC columns per CTA: 16, and fewer from 64 KiB of tile per plane on, so
  // that m = 4096 fits: 16384 / m on the int32 tile (2 planes x 4096 x 5
  // words x 4 B = 160 KiB, plus the 4 KiB coarse table of the in-kernel
  // epilogue), 8192 / m on the int64 tile (2 x 4096 x 3 x 8 B = 192 KiB).
  // Sixteen int16 columns are one 32-byte sector per row, the least a row
  // segment should be; against 32 columns the smaller tile lets an SM hold
  // four CTAs where it held three (m = 256, int32 tile), three where it
  // held one (m = 512; m = 256 on the int64 tile), and cuts the last,
  // part-filled wave: on an H100 the 64k headline ran 16 % faster, 512K
  // 10 %, the 24-bit widening path 21 % (tools/ab_torch_paths.py).
  const int fit = 65536 / (p.rows * static_cast<int>(sizeof(V)));
  p.tc = fit < 16 ? fit : 16;
  p.log_tc = log2_exact(p.tc);
  const size_t smem = 2u * p.rows * (p.tc + 1) * sizeof(V) +
                      (a.c_re != nullptr ? 2u * kCoarse * sizeof(int32_t)
                                         : 0u);
  const auto kernel = fused_pass_kernel<Tin, Tout, V, kInverse, kTwoD>;
  // the dynamic shared memory this instantiation may use on this device is
  // raised when a launch needs more than any before it, not on every call
  static size_t granted[kMaxDevices] = {};
  cudaError_t err = cudaSuccess;
  if (smem > granted[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted[device] = smem;
  }
  const auto i32 = [](const void* v) {
    return static_cast<const int32_t*>(v);
  };
  const unsigned tiles = (p.cols + p.tc - 1) / p.tc;
  const size_t item = static_cast<size_t>(p.rows) * p.cols;
  // gridDim.y holds at most kMaxGridY items: a larger batch takes several
  // launches, each on its own slice of x and y and each counted
  for (int b0 = 0; b0 < p.batch; b0 += kMaxGridY) {
    const int nb = p.batch - b0 < kMaxGridY ? p.batch - b0 : kMaxGridY;
    const size_t off = static_cast<size_t>(b0) * item;
    kernel<<<dim3(tiles, nb), kThreads, smem, stream>>>(
        static_cast<const Tin*>(a.x_re) + off,
        static_cast<const Tin*>(a.x_im) + off, i32(a.w_re), i32(a.w_im),
        i32(a.t2_re), i32(a.t2_im), i32(a.e_re), i32(a.e_im), i32(a.c_re),
        i32(a.c_im), static_cast<Tout*>(a.y_re) + off,
        static_cast<Tout*>(a.y_im) + off, p, syn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

// The 2-D stage tables are a template parameter, as the direction is, so
// the standard stages carry no branch of the other forms.  The int64 tile
// has no 2-D form (the caller checks).
template <typename Tin, typename Tout, typename V, bool kInverse>
cudaError_t launch_tables(const PassPtrs& a, const PassParams& p,
                          const SynthParams& syn, int device,
                          cudaStream_t stream, int* launches) {
  if constexpr (sizeof(V) == 4) {
    if (a.t2_re != nullptr) {
      return launch<Tin, Tout, V, kInverse, true>(a, p, syn, device, stream,
                                                  launches);
    }
  }
  return launch<Tin, Tout, V, kInverse, false>(a, p, syn, device, stream,
                                               launches);
}

}  // namespace
