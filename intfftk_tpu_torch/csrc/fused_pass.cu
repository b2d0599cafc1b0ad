// fused_pass.cu -- one factor pass of the integer four-step FFT, for Hopper
// (sm_90a).
//
// Replaces, on the NVIDIA H100, two Pallas TPU kernels of
// intfftk_tpu/ops/pallas_fft.py:
//   * _FusedFourStep._kernel (:1255, pallas_call at :1361) in its forward,
//     natural-order, narrow (<= 32-bit) form.  A 64k block is 256 KiB as
//     int16 complex, more than one CTA's 227 KB of shared memory, so the
//     whole-fused [n1, n2] tile that sits in VMEM on the TPU becomes two
//     launches of this kernel: factor 1 with the inter-factor twiddle and a
//     transposed store, then factor 2;
//   * _FusedPass._kernel (:965, pallas_call at :1097) in its narrow,
//     forward, table-epilogue form -- the same contract, once.
//
// What it computes, for each batch item b and column c of x[b, :, c]
// (R = m rows, m a power of two, 8 <= m <= 4096):
//   1. the m-point integer DIF with FFTConfig numerics (golden
//      int_model.dif_butterfly_int, pallas_fft._bfly_fwd);
//   2. the natural-order output reorder (row k is read at bitrev(k));
//   3. optionally y[k, c] * (er[k, c] + j*ei[k, c]) >> twiddle_shift,
//      wrapped to the factor's output width (the inter-factor twiddle);
//   4. a store to out[b, c, k] (transposed) or out[b, k, c], int16 or int32.
//
// What bounds it on this card: device-memory bytes set the floor.  At the
// main path's [64, 256, 256] int16 blocks each pass reads 16 MiB and writes
// 16 MiB, about 10 us at the data-sheet 3.35 TB/s.  On an H100 80GB HBM3
// at its 700 W limit this kernel takes about 0.1 ms per pass there, ten
// times that floor: it is bound by the integer work per sample (64-bit
// products, register wraps, index math) and its shared-memory traffic and
// barriers, which are still to be counted from its SASS.
//
// What the design does about it: one read and one write of device memory
// per pass; every stage, the reorder and the epilogue run on an int32 tile
// in shared memory.  One CTA holds one batch item and TC columns:
// [m, TC] re and im planes, rows padded to TC + 1 words.
//
// Numerics: every sum is formed in uint32 (modular, no signed overflow)
// and wrapped to the stage's output width with a shift pair, so the result
// equals the golden model's int64 arithmetic followed by its wrap; the
// complex products are exact 64-bit sums floor-shifted and then wrapped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct PassParams {
  int batch, rows, cols;   // x is [batch, rows, cols]
  int log_rows;            // log2(rows)
  int tc, log_tc;          // columns per CTA
  int data_width;          // width entering stage 0
  int scale;               // 1: scaled (per-stage /2), 0: unscaled
  int round;               // 1: round half up, 0: truncate
  int tw_shift;            // renormalising floor shift of every product
  int bypass;              // 1: no butterflies, reorder only (USE_FLY = 0)
  int transpose_out;       // 1: out is [batch, cols, rows]
};

// Low w bits of v as a signed w-bit value, 1 <= w <= 32.
__device__ __forceinline__ int32_t wrap32(uint32_t v, int w) {
  const int sh = 32 - w;
  return static_cast<int32_t>(v << sh) >> sh;
}

// (br + j*bi) * (c + j*d) >> sh, wrapped to w bits.  |data| < 2^31 and
// |twiddle| < 2^26 keep each 64-bit product-sum exact.
__device__ __forceinline__ void cmult(int32_t br, int32_t bi, int32_t c,
                                      int32_t d, int sh, int w, int32_t& yr,
                                      int32_t& yi) {
  const long long pr = (long long)br * c - (long long)bi * d;
  const long long pi = (long long)bi * c + (long long)br * d;
  yr = wrap32(static_cast<uint32_t>(pr >> sh), w);
  yi = wrap32(static_cast<uint32_t>(pi >> sh), w);
}

// DIF sum and difference with the mode's scale and rounding, wrapped to
// out_w bits (int_dif2_fly.vhd:144-241).  The round-mode difference reaches
// +2^(w-1) at (max, min) and wraps to -2^(w-1).
__device__ __forceinline__ void bfly(int32_t a, int32_t b, int in_w,
                                     const PassParams& p, int32_t& s,
                                     int32_t& d) {
  const int out_w = in_w + 1 - p.scale;
  uint32_t su, du;
  if (p.scale && !p.round) {
    su = static_cast<uint32_t>(a >> 1) + static_cast<uint32_t>(b >> 1);
    du = static_cast<uint32_t>(a >> 1) - static_cast<uint32_t>(b >> 1);
  } else if (p.scale) {
    // round_half_up(a +- b) without the wider sum
    // (intmath.add_round_half_up / sub_round_half_up)
    su = static_cast<uint32_t>(a >> 1) + static_cast<uint32_t>(b >> 1) +
         static_cast<uint32_t>((a | b) & 1);
    du = static_cast<uint32_t>(a >> 1) - static_cast<uint32_t>(b >> 1) +
         static_cast<uint32_t>(a & ~b & 1);
  } else {
    su = static_cast<uint32_t>(a) + static_cast<uint32_t>(b);
    du = static_cast<uint32_t>(a) - static_cast<uint32_t>(b);
  }
  s = wrap32(su, out_w);
  d = wrap32(du, out_w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_pass_kernel(const T* __restrict__ x_re, const T* __restrict__ x_im,
                  const int32_t* __restrict__ w_re,
                  const int32_t* __restrict__ w_im,
                  const int32_t* __restrict__ e_re,
                  const int32_t* __restrict__ e_im, T* __restrict__ y_re,
                  T* __restrict__ y_im, const PassParams p) {
  extern __shared__ int32_t smem[];
  const int m = p.rows, tc = p.tc, ld = tc + 1;
  int32_t* s_re = smem;
  int32_t* s_im = smem + m * ld;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * tc;
  const size_t item = static_cast<size_t>(b) * m * p.cols;
  const int tile = m * tc;

  // load [m, TC], coalesced along the columns; the tail tile reads zeros
  for (int u = threadIdx.x; u < tile; u += kThreads) {
    const int r = u >> p.log_tc, c = u & (tc - 1), col = c0 + c;
    int32_t vr = 0, vi = 0;
    if (col < p.cols) {
      const size_t g = item + static_cast<size_t>(r) * p.cols + col;
      vr = x_re[g];
      vi = x_im[g];
    }
    s_re[r * ld + c] = vr;
    s_im[r * ld + c] = vi;
  }
  __syncthreads();

  // every stage in shared memory: stage s pairs rows i and i + 2^q,
  // q = log2(m) - 1 - s the twiddle order
  const int n_stages = p.bypass ? 0 : p.log_rows;
  for (int s = 0; s < n_stages; ++s) {
    const int q = p.log_rows - 1 - s;
    const int h = 1 << q;
    const int in_w = p.data_width + s * (1 - p.scale);
    const int out_w = in_w + 1 - p.scale;
    for (int u = threadIdx.x; u < (tile >> 1); u += kThreads) {
      const int c = u & (tc - 1), t = u >> p.log_tc;
      const int k = t & (h - 1);
      const int i = (((t >> q) << (q + 1)) | k) * ld + c;
      const int j = i + h * ld;
      int32_t sr, si, dr, di, yr, yi;
      bfly(s_re[i], s_re[j], in_w, p, sr, dr);
      bfly(s_im[i], s_im[j], in_w, p, si, di);
      if (q == 0) {
        yr = dr;
        yi = di;
      } else if (q == 1) {
        // W = -j on the odd index: (re, im) = (im, neg_guarded(re)),
        // neg_guarded(x) = (x >> 31) - x, exact at INT32_MIN
        if (k & 1) {
          yr = di;
          yi = static_cast<int32_t>(static_cast<uint32_t>(dr >> 31) -
                                    static_cast<uint32_t>(dr));
        } else {
          yr = dr;
          yi = di;
        }
      } else {
        cmult(dr, di, __ldg(w_re + h + k), __ldg(w_im + h + k), p.tw_shift,
              out_w, yr, yi);
      }
      s_re[i] = sr;
      s_im[i] = si;
      s_re[j] = yr;
      s_im[j] = yi;
    }
    __syncthreads();
  }

  // natural output row k lives at shared row bitrev(k)
  const int rev_sh = 32 - p.log_rows;
  if (e_re != nullptr) {
    const int ow = p.data_width + p.log_rows * (1 - p.scale);
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int k = u >> p.log_tc, c = u & (tc - 1), col = c0 + c;
      if (col < p.cols) {
        const int a = (__brev(k) >> rev_sh) * ld + c;
        const size_t g = static_cast<size_t>(k) * p.cols + col;
        int32_t yr, yi;
        cmult(s_re[a], s_im[a], __ldg(e_re + g), __ldg(e_im + g), p.tw_shift,
              ow, yr, yi);
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
        const int a = (__brev(k) >> rev_sh) * ld + c;
        const size_t g = item + static_cast<size_t>(col) * m + k;
        y_re[g] = static_cast<T>(s_re[a]);
        y_im[g] = static_cast<T>(s_im[a]);
      }
    }
  } else {
    for (int u = threadIdx.x; u < tile; u += kThreads) {
      const int k = u >> p.log_tc, c = u & (tc - 1), col = c0 + c;
      if (col < p.cols) {
        const int a = (__brev(k) >> rev_sh) * ld + c;
        const size_t g = item + static_cast<size_t>(k) * p.cols + col;
        y_re[g] = static_cast<T>(s_re[a]);
        y_im[g] = static_cast<T>(s_im[a]);
      }
    }
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

template <typename T>
cudaError_t launch(const void* x_re, const void* x_im, const void* w_re,
                   const void* w_im, const void* e_re, const void* e_im,
                   void* y_re, void* y_im, PassParams p, cudaStream_t stream) {
  // TC columns per CTA: 32 up to m = 512, then fewer so that m = 4096
  // still fits (2 planes x 4096 x 5 words x 4 B = 160 KiB)
  p.tc = p.rows <= 512 ? 32 : 16384 / p.rows;
  p.log_tc = log2_exact(p.tc);
  const size_t smem = 2u * p.rows * (p.tc + 1) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.cols + p.tc - 1) / p.tc, p.batch);
  fused_pass_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x_re), static_cast<const T*>(x_im),
      static_cast<const int32_t*>(w_re), static_cast<const int32_t*>(w_im),
      static_cast<const int32_t*>(e_re), static_cast<const int32_t*>(e_im),
      static_cast<T*>(y_re), static_cast<T*>(y_im), p);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes (intfftk_tpu_torch/ops/_build.py).
// Pointers are device pointers; e_re/e_im may be null (no epilogue).
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int intfft_fused_pass(const void* x_re, const void* x_im,
                                 void* y_re, void* y_im, const void* w_re,
                                 const void* w_im, const void* e_re,
                                 const void* e_im, int batch, int rows,
                                 int cols, int io16, int data_width, int scale,
                                 int round, int tw_shift, int bypass,
                                 int transpose_out, int device,
                                 void* stream) {
  const int log_rows = log2_exact(rows);
  if (log_rows < 3 || log_rows > 12 || batch < 1 || batch > 65535 ||
      cols < 1 ||
      data_width < 1 || data_width + (1 - scale) * log_rows > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  PassParams p{batch, rows,  cols,     log_rows, 0,      0,
               data_width, scale, round, tw_shift, bypass, transpose_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = io16 ? launch<int16_t>(x_re, x_im, w_re, w_im, e_re, e_im, y_re,
                               y_im, p, s)
             : launch<int32_t>(x_re, x_im, w_re, w_im, e_re, e_im, y_re,
                               y_im, p, s);
  return static_cast<int>(err);
}

extern "C" const char* intfft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
