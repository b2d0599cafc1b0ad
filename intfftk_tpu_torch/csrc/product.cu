// product.cu -- the renormalised spectrum product of the FFT -> product ->
// IFFT chains, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: in the JAX package the product is plain
// jnp arithmetic inside the chain's one jit
// (intfftk_tpu/parallel/convolve.py:184-197, bench.py:695).  Eager PyTorch
// runs the same arithmetic as about a dozen elementwise kernels, each a
// pass over device memory; this is the one pass.
//
// What it computes, for every element e of [B, *block] data (fr, fi) and a
// spectrum table (hr, hi) of `block` entries, broadcast over B, with
// c + j*d = h[e mod block]:
//   re = wrap((fr*c - fi*d) >> shift, out_width)
//   im = wrap((fi*c + fr*d) >> shift, out_width)
// each product-sum exact before the floor shift (cmult of
// intfft_arith.cuh), equal to ops/intmath.cmult_exact.  Data int32 or
// int64, table int32 (|h| < 2^26), output int32 (out_width <= 32) or
// int64.  The product-sum's type is a template parameter chosen by the
// host: long long where datum + spectrum + 1 bits fit 63 (a 32-bit datum
// against a 25-bit spectrum), __int128 above (a 48-bit datum).
//
// What bounds it: device-memory bytes: each datum read once, each result
// written once (a 64k-block convolution over 64 blocks moves 4 194 304 x
// (8 + 16) bytes); the table is `block` entries, read by every batch item
// and served by L2.  What the design does about it: a grid-stride loop
// over runs of elements, a run being 16 bytes of the wider of the two
// element types (four int32, two where either side is int64), so that a
// warp's widest access covers 512 contiguous bytes and every 32-byte
// sector is written whole by one instruction; element counts or pointers
// that the run does not divide take the same loop one element at a time.

#include <cstdint>
#include <cuda_runtime.h>

#include "intfft_arith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kMaxDevices = 64;  // devices a process may launch on

// Makes `device` the calling thread's current device unless it is already
// (a cudaSetDevice on every call cost the host time on every launch).
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// The SMs of `device`, read once per device; 0 where it cannot be read.
int sm_count(int device) {
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess) {
    sms[device] = 0;
  }
  return sms[device];
}

// elements of a run: 16 bytes of the wider type
template <typename Tin, typename Tout>
constexpr int kRun =
    16 / static_cast<int>(sizeof(Tin) > sizeof(Tout) ? sizeof(Tin)
                                                     : sizeof(Tout));

template <typename T, int N>
struct alignas(sizeof(T) * N) Run {
  T v[N];
};

// N elements per step: a 16-byte run (kRun of the two types), or 1.
template <typename Tin, typename Tout, typename P, int N>
__global__ void __launch_bounds__(kThreads)
product_kernel(const Tin* __restrict__ f_re, const Tin* __restrict__ f_im,
               const int32_t* __restrict__ h_re,
               const int32_t* __restrict__ h_im, Tout* __restrict__ y_re,
               Tout* __restrict__ y_im, size_t runs, size_t block_runs,
               int shift, int out_width) {
  using In = Run<Tin, N>;
  using Tab = Run<int32_t, N>;
  using Out = Run<Tout, N>;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < runs; i += stride) {
    const size_t t = i % block_runs;
    const In fr = reinterpret_cast<const In*>(f_re)[i];
    const In fi = reinterpret_cast<const In*>(f_im)[i];
    const Tab c = reinterpret_cast<const Tab*>(h_re)[t];
    const Tab d = reinterpret_cast<const Tab*>(h_im)[t];
    Out yr, yi;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      int64_t pr, pi;
      cmult<int64_t, P>(fr.v[e], fi.v[e], c.v[e], d.v[e], shift, out_width,
                        pr, pi);
      yr.v[e] = static_cast<Tout>(pr);
      yi.v[e] = static_cast<Tout>(pi);
    }
    reinterpret_cast<Out*>(y_re)[i] = yr;
    reinterpret_cast<Out*>(y_im)[i] = yi;
  }
}

struct ProductArgs {
  const void *f_re, *f_im, *h_re, *h_im;
  void *y_re, *y_im;
  long long n, block;
  int shift, out_width, ctas;
};

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename Tin, typename Tout, typename P>
cudaError_t launch_product(const ProductArgs& a, cudaStream_t stream) {
  const auto in = [](const void* v) { return static_cast<const Tin*>(v); };
  const auto tab = [](const void* v) {
    return static_cast<const int32_t*>(v);
  };
  const auto out = [](void* v) { return static_cast<Tout*>(v); };
  constexpr int kN = kRun<Tin, Tout>;
  const bool whole_runs =
      a.n % kN == 0 && a.block % kN == 0 &&
      aligned(a.f_re, kN * sizeof(Tin)) && aligned(a.f_im, kN * sizeof(Tin)) &&
      aligned(a.h_re, kN * 4) && aligned(a.h_im, kN * 4) &&
      aligned(a.y_re, kN * sizeof(Tout)) && aligned(a.y_im, kN * sizeof(Tout));
  const int per = whole_runs ? kN : 1;
  const size_t runs = static_cast<size_t>(a.n / per);
  const size_t want = (runs + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(
      want < static_cast<size_t>(a.ctas) ? want : a.ctas);
  if (whole_runs) {
    product_kernel<Tin, Tout, P, kN><<<grid, kThreads, 0, stream>>>(
        in(a.f_re), in(a.f_im), tab(a.h_re), tab(a.h_im), out(a.y_re),
        out(a.y_im), runs, static_cast<size_t>(a.block / kN), a.shift,
        a.out_width);
  } else {
    product_kernel<Tin, Tout, P, 1><<<grid, kThreads, 0, stream>>>(
        in(a.f_re), in(a.f_im), tab(a.h_re), tab(a.h_im), out(a.y_re),
        out(a.y_im), runs, static_cast<size_t>(a.block), a.shift,
        a.out_width);
  }
  return cudaGetLastError();
}

}  // namespace

// One launch of the spectrum product over n elements (device pointers):
// f_re/f_im and y_re/y_im hold n elements of in_size and out_size bytes
// (4: int32, 8: int64), h_re/h_im hold `block` int32 entries, and n is a
// multiple of block.  wide_product: 1 forms the product-sums in __int128
// (int64 data only), 0 in long long.  out_width <= 8 * out_size bits.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int intfft_spectrum_product(
    const void* f_re, const void* f_im, const void* h_re, const void* h_im,
    void* y_re, void* y_im, long long n, long long block, int in_size,
    int out_size, int wide_product, int shift, int out_width, int device,
    void* stream) {
  if (n < 1 || block < 1 || n % block != 0 ||
      (in_size != 4 && in_size != 8) || (out_size != 4 && out_size != 8) ||
      (wide_product && in_size != 8) || shift < 0 || shift > 62 ||
      out_width < 1 || out_width > 8 * out_size || device < 0 ||
      device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(device);
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const ProductArgs a{f_re, f_im, h_re, h_im,    y_re,      y_im,
                      n,    block, shift, out_width, sms * kCtasPerSm};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_size == 4) {
    err = out_size == 4 ? launch_product<int32_t, int32_t, long long>(a, s)
                        : launch_product<int32_t, int64_t, long long>(a, s);
  } else if (wide_product) {
    err = out_size == 4 ? launch_product<int64_t, int32_t, __int128>(a, s)
                        : launch_product<int64_t, int64_t, __int128>(a, s);
  } else {
    err = out_size == 4 ? launch_product<int64_t, int32_t, long long>(a, s)
                        : launch_product<int64_t, int64_t, long long>(a, s);
  }
  return static_cast<int>(err);
}
