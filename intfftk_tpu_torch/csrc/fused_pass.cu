// fused_pass.cu -- one factor pass of the integer FFT, for Hopper (sm_90a).
//
// Replaces, on the NVIDIA H100, four Pallas TPU kernels of
// intfftk_tpu/ops/pallas_fft.py, all of which run the one stage body
// _transform_rows (:501-559) or its 2-D twin _transform_rows_2d (:406-430),
// and the twiddle generator synth_circle_block of
// intfftk_tpu/ops/twiddle_synth.py:126:
//   * _FusedFourStep._kernel (:1255, pallas_call at :1361) in its narrow
//     (<= 32-bit) forms: forward and inverse, natural and raw order.  A 64k
//     block is 256 KiB as int16 complex, more than one CTA's 227 KB of
//     shared memory, so the whole-fused [n1, n2] tile that sits in VMEM on
//     the TPU becomes two launches of this kernel: factor 1 with the
//     inter-factor twiddle and a transposed store, then factor 2;
//   * _FusedPass._kernel (:965, pallas_call at :1097) in its narrow
//     forms, with the epilogue from a table or synthesized in the kernel
//     (epi_synth_n, :1000-1025), and the transposed load and store
//     (FusedAxisFFT, the Channelizer's "cn" layout);
//   * _FusedFourStep._kernel_monolithic (:1204, pallas_call at :1361): the
//     monolithic schedule as two launches, the i1 factor's stages with 2-D
//     full-size twiddle tables (this kernel with t2_re/t2_im), the other
//     factor standard;
//   * PallasFFTPlan._kernel (:829, pallas_call at :855): the single-pass
//     n <= 4096 transform of an [n, B] tile, launched on a [1, n, B] view
//     ("nb"), or on [1, B, n] with the transposed load and store ("bn");
//   * synth_circle_block (twiddle_synth.py:126; inside _FusedPass and as
//     the XLA generator device_circle_table, :103): synth_twiddle below,
//     run by the epilogue and by the generator kernel circle_table_kernel;
//   * the wide (> 32-bit) forms of _FusedFourStep._kernel and
//     _FusedPass._kernel (wide_in / wide1 / wide2, :1268-1307, :982-1044)
//     and PallasWideFFTPlan._kernel (:742, pallas_call at :764), whose
//     stages _transform_wide / _stage_wide (:577-713) carry data as two
//     int32 limb planes because the TPU has no int64.  Here the same
//     numerics run on an int64 tile: the widening pass loads int32 into it,
//     the wide pass loads int64, and both store int64.
//
// What it computes, for each batch item b and column c of x[b, :, c]
// (R = m rows, m a power of two, 8 <= m <= 4096):
//   1. the load: x[b, r, c], or x[b, c, r] with transpose_in (a [B, C, R]
//      operand, read along R); the inverse in natural order puts row r at
//      shared row bitrev(r), as its DIT stages consume a bit-reversed
//      spectrum;
//   2. the m-point integer transform with FFTConfig numerics: forward DIF
//      (golden int_model.dif_butterfly_int, pallas_fft._bfly_fwd), or
//      inverse DIT, the B operand times the conjugate twiddle wrapped to
//      the stage's input width before the same butterfly
//      (_dit_stage_rows, _bfly_inv); with 2-D tables t2[R, C], stage order
//      q reads its twiddle at t2[2^q + k, col] and every stage multiplies,
//      q = 0 and 1 included (_stage_rows_2d);
//   3. the forward in natural order reads stored row k at bitrev(k); with
//      natural off (the raw core contract) neither side is reordered;
//   4. optionally stored row k times (er[k, c] + j*ei[k, c]) >>
//      twiddle_shift, wrapped to the factor's output width (the
//      inter-factor twiddle); with the coarse table instead of er/ei, the
//      twiddle W_n^(+-k*col) is synthesized here (col = the global column)
//      from the 4 KiB table staged in shared memory, so no O(N) array
//      exists;
//   5. a store to out[b, c, k] (transpose_out) or out[b, k, c], int16,
//      int32 or int64.
//
// What bounds it on this card: device-memory bytes set the floor.  At the
// 64k path's [64, 256, 256] int16 blocks each pass reads 16 MiB and writes
// 16 MiB, about 10 us at the data-sheet 3.35 TB/s.  On an H100 80GB HBM3
// at its 700 W limit this kernel takes about 0.1 ms per pass there, ten
// times that floor: it is bound by the integer work per sample (64-bit
// products, register wraps, index math) and its shared-memory traffic and
// barriers (tools/audit_sass.py counts them from its SASS, per stage through
// probe_stages.cu).  At m = 4096 a
// CTA holds only 4 columns (160 KiB of shared memory, one CTA per SM), so
// the [n, B] load reads 16-byte row segments.
//
// What the design does about it: one read and one write of device memory
// per pass; every stage, both reorders and the epilogue run on an int32
// tile in shared memory.  The epilogue's table is a second read of the
// pass's size; synthesizing it trades those bytes for about 25 integer
// operations per sample, and the generator kernel makes the table once per
// plan instead.  The 2-D stage tables of the monolithic pass are read once
// per stage per sample, coalesced along the columns.  One CTA holds one
// batch item and TC columns: [m, TC] re and im planes, rows padded to
// TC + 1 words.  The direction and the 2-D tables are template
// parameters, so the forward body carries no inverse branch and the
// standard stages no 2-D one.
//
// Numerics: the arithmetic of intfft_arith.cuh (modular sums wrapped to the
// stage's width, exact product-sums floor-shifted and wrapped), and the
// stage body of stage_body.cuh, which the per-stage probe
// (probe_stages.cu) runs too.  The tile type is a template parameter, so
// the int32 instantiations are the narrow kernel unchanged.  An int64 tile
// holds twice the bytes: TC halves from m = 512 on (TC = 2 at m = 4096,
// 192 KiB), and it takes neither the in-kernel synthesis nor the 2-D stage
// tables (the JAX package has no wide form of either).
//
// The batch is the grid's y dimension, which holds at most 65 535 items: a
// larger batch goes out as several launches of that many items each, on
// the same stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "stage_body.cuh"

namespace {

// The twiddle generator's constants for the full size n = 2^log_n
// (twiddle_synth.synth_params): the Taylor pi constant of stage order
// log_n - 1, the MACC's XSHIFT, and the low address bits of the count.
struct SynthParams {
  int log_n, mathpi, xshift, sh_cnt;
};

constexpr int kCoarse = 512;     // entries of the coarse quarter table
constexpr int kMaxGridY = 65535; // the most items one launch takes

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

// The generator: er/ei[k, j] = W_n^(+-k*j) for an [n1, n2] table, one
// thread per entry (device_circle_table).  The coarse table is read
// through the read-only cache: 4 KiB, shared by every thread.
__global__ void __launch_bounds__(kThreads)
circle_table_kernel(const int32_t* __restrict__ cre,
                    const int32_t* __restrict__ cim, int32_t* __restrict__ er,
                    int32_t* __restrict__ ei, int n1, int n2, int inverse,
                    const SynthParams s) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n1 * n2) return;
  const int n = 1 << s.log_n;
  int m = (g / n2) * (g % n2);          // < n: the host checks the block
  if (inverse) m = (n - m) & (n - 1);
  int32_t wr, wi;
  synth_twiddle(m, cre, cim, s, wr, wi);
  er[g] = wr;
  ei[g] = wi;
}

// Tin / Tout: the element types of x and y; V: the tile's (int32, or
// int64 for the wide forms).
template <typename Tin, typename Tout, typename V, bool kInverse, bool kTwoD>
__global__ void __launch_bounds__(kThreads)
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
  V* const smem = reinterpret_cast<V*>(smem_raw);
  const int m = p.rows, tc = p.tc, ld = tc + 1;
  V* s_re = smem;
  V* s_im = smem + m * ld;
  // the coarse table of the in-kernel epilogue, after the two planes; the
  // int64 tile never synthesizes
  int32_t* s_cre = reinterpret_cast<int32_t*>(smem + 2 * m * ld);
  int32_t* s_cim = s_cre + kCoarse;
  const bool synth = sizeof(V) == 4 && c_re != nullptr;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * tc;
  const size_t item = static_cast<size_t>(b) * m * p.cols;
  const int tile = m * tc;
  const int rev_sh = 32 - p.log_rows;
  // which side is reordered: the inverse's load, the forward's store
  const bool rev_in = kInverse && p.natural;
  const bool rev_out = !kInverse && p.natural;

  // load [m, TC], coalesced along the columns, or along the rows of a
  // [B, C, R] operand; the tail tile reads zeros
  for (int u = threadIdx.x; u < tile; u += kThreads) {
    int r, c;
    if (p.transpose_in) {
      r = u & (m - 1);
      c = u >> p.log_rows;
    } else {
      r = u >> p.log_tc;
      c = u & (tc - 1);
    }
    const int col = c0 + c;
    V vr = 0, vi = 0;
    if (col < p.cols) {
      const size_t g = item + (p.transpose_in
                                   ? static_cast<size_t>(col) * m + r
                                   : static_cast<size_t>(r) * p.cols + col);
      vr = x_re[g];
      vi = x_im[g];
    }
    const int a = (rev_in ? (__brev(r) >> rev_sh) : r) * ld + c;
    s_re[a] = vr;
    s_im[a] = vi;
  }
  if (synth) {
    for (int u = threadIdx.x; u < kCoarse; u += kThreads) {
      s_cre[u] = __ldg(c_re + u);
      s_cim[u] = __ldg(c_im + u);
    }
  }
  __syncthreads();

  // every stage in shared memory: stage s pairs rows i and i + 2^q, q the
  // twiddle order: log2(m) - 1 - s forward (DIF), s inverse (DIT)
  const int n_stages = p.bypass ? 0 : p.log_rows;
  for (int s = 0; s < n_stages; ++s) {
    const int q = kInverse ? s : p.log_rows - 1 - s;
    const int h = 1 << q;
    const int in_w = p.data_width + s * (1 - p.scale);
    const int out_w = in_w + 1 - p.scale;
    for (int u = threadIdx.x; u < (tile >> 1); u += kThreads) {
      stage_body<V, kInverse, kTwoD>(s_re, s_im, u, q, h, in_w, out_w, p, c0,
                                     w_re, w_im, t2_re, t2_im);
    }
    __syncthreads();
  }

  // stored row k lives at shared row bitrev(k) in the natural forward,
  // at row k otherwise
  if (e_re != nullptr || synth) {
    const int ow = p.data_width + p.log_rows * (1 - p.scale);
    const int n_full = 1 << syn.log_n;
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int k = u >> p.log_tc, c = u & (tc - 1), col = c0 + c;
      if (col < p.cols) {
        const int a = (rev_out ? (__brev(k) >> rev_sh) : k) * ld + c;
        int32_t wr, wi;
        if (synth) {
          // k * col < n: the host checks the block against n
          int mi = k * col;
          if (kInverse) mi = (n_full - mi) & (n_full - 1);
          synth_twiddle(mi, s_cre, s_cim, syn, wr, wi);
        } else {
          const size_t g = static_cast<size_t>(k) * p.cols + col;
          wr = __ldg(e_re + g);
          wi = __ldg(e_im + g);
        }
        V yr, yi;
        cmult(s_re[a], s_im[a], wr, wi, p.tw_shift, ow, yr, yi);
        s_re[a] = yr;
        s_im[a] = yi;
      }
    }
    __syncthreads();
  }

  if (p.transpose_out) {
    // out[b, col, k]: m contiguous values per column
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int k = u & (m - 1), c = u >> p.log_rows, col = c0 + c;
      if (col < p.cols) {
        const int a = (rev_out ? (__brev(k) >> rev_sh) : k) * ld + c;
        const size_t g = item + static_cast<size_t>(col) * m + k;
        y_re[g] = static_cast<Tout>(s_re[a]);
        y_im[g] = static_cast<Tout>(s_im[a]);
      }
    }
  } else {
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int k = u >> p.log_tc, c = u & (tc - 1), col = c0 + c;
      if (col < p.cols) {
        const int a = (rev_out ? (__brev(k) >> rev_sh) : k) * ld + c;
        const size_t g = item + static_cast<size_t>(k) * p.cols + col;
        y_re[g] = static_cast<Tout>(s_re[a]);
        y_im[g] = static_cast<Tout>(s_im[a]);
      }
    }
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The pointers of one launch: stage tables (1-D w, or 2-D t2), epilogue
// (table e, or coarse table c), data in and out.
struct PassPtrs {
  const void *x_re, *x_im, *w_re, *w_im, *t2_re, *t2_im, *e_re, *e_im,
      *c_re, *c_im;
  void *y_re, *y_im;
};

template <typename Tin, typename Tout, typename V, bool kInverse,
          bool kTwoD>
cudaError_t launch(const PassPtrs& a, PassParams p, const SynthParams& syn,
                   cudaStream_t stream, int* launches) {
  // TC columns per CTA: 32, and fewer from 64 KiB of tile per plane on, so
  // that m = 4096 fits: 16384 / m on the int32 tile (2 planes x 4096 x 5
  // words x 4 B = 160 KiB, plus the 4 KiB coarse table of the in-kernel
  // epilogue), 8192 / m on the int64 tile (2 x 4096 x 3 x 8 B = 192 KiB)
  const int fit = 65536 / (p.rows * static_cast<int>(sizeof(V)));
  p.tc = fit < 32 ? fit : 32;
  p.log_tc = log2_exact(p.tc);
  const size_t smem = 2u * p.rows * (p.tc + 1) * sizeof(V) +
                      (a.c_re != nullptr ? 2u * kCoarse * sizeof(int32_t)
                                         : 0u);
  const auto kernel = fused_pass_kernel<Tin, Tout, V, kInverse, kTwoD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
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

// The direction and the 2-D stage tables are template parameters, so the
// standard stages carry no branch of the other forms.  The int64 tile has
// no 2-D form (the caller checks).
template <typename Tin, typename Tout, typename V>
cudaError_t launch_dir(int inverse, const PassPtrs& a, const PassParams& p,
                       const SynthParams& syn, cudaStream_t stream,
                       int* launches) {
  if constexpr (sizeof(V) == 4) {
    if (a.t2_re != nullptr) {
      return inverse
                 ? launch<Tin, Tout, V, true, true>(a, p, syn, stream,
                                                    launches)
                 : launch<Tin, Tout, V, false, true>(a, p, syn, stream,
                                                     launches);
    }
  }
  return inverse ? launch<Tin, Tout, V, true, false>(a, p, syn, stream,
                                                     launches)
                 : launch<Tin, Tout, V, false, false>(a, p, syn, stream,
                                                      launches);
}

// A synthesis block [rows, cols] of size n = 2^log_n: every index
// k * j < n, and the Taylor regime (stage order log_n - 1 >= 11).
bool synth_ok(const SynthParams& s, int rows, int cols) {
  return s.log_n >= 12 && s.log_n <= 30 && s.sh_cnt >= 0 &&
         s.sh_cnt <= s.log_n - 3 &&
         static_cast<long long>(rows - 1) * (cols - 1) < (1LL << s.log_n);
}

}  // namespace

// Plain C interface, loaded with ctypes (intfftk_tpu_torch/ops/_build.py).
// Pointers are device pointers.  Stage tables: w_re/w_im [rows], or, when
// t2_re/t2_im are given, 2-D tables [rows, cols] (w may be null then).
// Epilogue: e_re/e_im [rows, cols], or the coarse table c_re/c_im [512]
// with the synthesis constants, or neither (both null).  in_size and
// out_size are the bytes of an element of x and y: (2, 2) and (4, 4) run
// on the int32 tile with outputs of <= 32 bits; (4, 8), the widening pass,
// and (8, 8) on the int64 tile with outputs of <= 64 bits, no 2-D tables
// and no synthesis.  *launches receives the kernel launches made: one for
// every 65 535 items of the batch, or part of them.
// Returns a cudaError_t: 0 when every launch was accepted.
extern "C" int intfft_fused_pass(
    const void* x_re, const void* x_im, void* y_re, void* y_im,
    const void* w_re, const void* w_im, const void* t2_re, const void* t2_im,
    const void* e_re, const void* e_im, const void* c_re, const void* c_im,
    int batch, int rows, int cols, int in_size, int out_size,
    int data_width, int scale, int round, int tw_shift, int bypass,
    int inverse, int natural, int transpose_in, int transpose_out,
    int synth_log_n, int mathpi, int xshift, int sh_cnt, int device,
    void* stream, int* launches) {
  *launches = 0;
  const int log_rows = log2_exact(rows);
  const SynthParams syn{synth_log_n, mathpi, xshift, sh_cnt};
  const bool narrow = in_size == out_size && (in_size == 2 || in_size == 4);
  const bool wide = out_size == 8 && (in_size == 4 || in_size == 8);
  if (log_rows < 3 || log_rows > 12 || batch < 1 || cols < 1 ||
      data_width < 1 || !(narrow || wide) ||
      data_width + (1 - scale) * log_rows > (wide ? 64 : 32) ||
      (t2_re == nullptr && w_re == nullptr) ||
      (e_re != nullptr && c_re != nullptr) ||
      (wide && (t2_re != nullptr || c_re != nullptr)) ||
      (c_re != nullptr && !synth_ok(syn, rows, cols))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  PassParams p{batch,    rows,   cols,    log_rows,     0,
               0,        data_width, scale, round,      tw_shift,
               bypass,   natural, transpose_in, transpose_out};
  const PassPtrs a{x_re, x_im, w_re, w_im, t2_re, t2_im, e_re, e_im,
                   c_re, c_im, y_re, y_im};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_size == 2) {
    err = launch_dir<int16_t, int16_t, int32_t>(inverse, a, p, syn, s,
                                                launches);
  } else if (!wide) {
    err = launch_dir<int32_t, int32_t, int32_t>(inverse, a, p, syn, s,
                                                launches);
  } else if (in_size == 4) {
    err = launch_dir<int32_t, int64_t, int64_t>(inverse, a, p, syn, s,
                                                launches);
  } else {
    err = launch_dir<int64_t, int64_t, int64_t>(inverse, a, p, syn, s,
                                                launches);
  }
  return static_cast<int>(err);
}

// The [n1, n2] inter-factor table W_n^(+-k*j) from the coarse table
// c_re/c_im [512] (device pointers), written to er/ei [n1, n2].
extern "C" int intfft_circle_table(const void* c_re, const void* c_im,
                                   void* er, void* ei, int n1, int n2,
                                   int inverse, int log_n, int mathpi,
                                   int xshift, int sh_cnt, int device,
                                   void* stream) {
  const SynthParams syn{log_n, mathpi, xshift, sh_cnt};
  if (n1 < 1 || n2 < 1 || !synth_ok(syn, n1, n2) ||
      static_cast<long long>(n1) * n2 > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n1 * n2;
  circle_table_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c_re), static_cast<const int32_t*>(c_im),
      static_cast<int32_t*>(er), static_cast<int32_t*>(ei), n1, n2, inverse,
      syn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* intfft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
