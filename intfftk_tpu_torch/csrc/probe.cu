// probe.cu -- the card's integer-instruction and memory ceilings, for Hopper
// (sm_90a): the denominators of every kernel's roofline bound.
//
// Replaces, on the NVIDIA H100, the three Pallas TPU measurement kernels of
// tools/probe_vpu.py:
//   * _chain_kernel (:49, pallas_call at :64): K iterations of a dependent
//     op chain body(c) on a resident [512, 512] int32 tile, for the bodies
//     add, add16x, mul, mul16x, shift, bitwise, _mixed7 (:77),
//     _stage_mix10 (:88), select and roll -> chain_kernel<BODY, uint32_t>;
//   * probe_hbm (:135, pallas_call at :144): o = x + 1 over 2^28 bytes each
//     way -> copy_kernel;
//   * the int16 add chain mk16 (:219-236, pallas_call at :226): c = c + c on
//     int16 storage -> chain_kernel<kAdd, uint16_t>, and as a second body
//     two int16 values packed in one 32-bit register (kAddPacked).
//
// What they compute.  chain_kernel: every thread loads kIlp independent
// values from device memory (element (blockIdx * kIlp + j) * kThreads +
// threadIdx), applies body to each K times, K a run-time argument, and
// stores them: y = body^K(x) with two's-complement wrap-around, equal to
// chain_reference of intfftk_tpu_torch/tools/probe_vpu.py.  The TPU tile's
// 256 independent vregs become kIlp independent chains per thread times
// 1024 or more resident threads per SM.  roll is the rotate by one place
// within each run of 32 consecutive elements (one warp's lanes: a shuffle)
// plus one.  copy_kernel: y = x + 1 over int32 words, a grid-stride loop of
// 16-byte loads and stores.
//
// What bounds them: by construction chain_kernel is bound by integer
// instruction rate (its load and store are 2 x 4 bytes per element against
// K x ops, and cancel in the two-K difference the wrapper times), and
// copy_kernel by device-memory bytes (2^28 bytes each way, five times the
// 50 MB L2).
//
// What the design does about the compiler.  nvcc -O3 and ptxas fold what
// Mosaic emits verbatim, so: inputs come from memory and differ per thread
// and results are stored (nothing is constant or dead); the K loop is
// "#pragma unroll 1" (no folding across iterations); all arithmetic is
// unsigned (wrap-around, nothing for the compiler to assume away).  Fusing
// WITHIN an iteration (IMAD, LOP3, SHF) is left to the compiler: that is
// the card's rate for the blend, and ops are counted at source level, as
// the TPU tool counts them.  On an H100 (CUDA 12.8) ptxas compiles c + c to
// a shift, the sixteen of add16x to ONE shift by 16 (an empty asm barrier
// between them does not stop it: ptxas folds the PTX adds), the seven ops
// of mixed7 to four instructions (c * ((c | 1) * c + 2) + (c >> 1): LOP3,
// IMAD, SHF, IMAD) and the ten of stagemix10 to seven; mul16x stays
// sixteen multiplies and the packed int16 add is the native VIADD.16x2.
// So add16x reads sixteen times the shift rate and says nothing of adds;
// the wrapper's Body.min_instr records these floors.  The wrapper holds
// every reading to two guards (time linear in K; no rate above lanes x
// clock x ops per instruction), and prints the SASS instruction count of
// each loop where cuobjdump exists.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// independent chains per thread
constexpr int kIlp = 8;

// the chain bodies, in the order of BODIES in the wrapper's module
enum Body : int {
  kAdd = 0,
  kAdd16x = 1,
  kMul = 2,
  kMul16x = 3,
  kShift = 4,
  kBitwise = 5,
  kMixed7 = 6,
  kStageMix10 = 7,
  kSelect = 8,
  kRoll = 9,
  kAddPacked = 10,
  kBodies = 11
};

// arithmetic shift right of the two's-complement value in u
__device__ __forceinline__ uint32_t sra(uint32_t u, int s) {
  return static_cast<uint32_t>(static_cast<int32_t>(u) >> s);
}

template <int BODY>
__device__ __forceinline__ uint32_t body(uint32_t c) {
  if constexpr (BODY == kAdd) {
    return c + c;
  } else if constexpr (BODY == kAdd16x) {
#pragma unroll
    for (int i = 0; i < 16; ++i) c = c + c;
    return c;
  } else if constexpr (BODY == kMul) {
    return c * c;
  } else if constexpr (BODY == kMul16x) {
#pragma unroll
    for (int i = 0; i < 16; ++i) c = c * c;
    return c;
  } else if constexpr (BODY == kShift) {
    return sra(c, 1) << 1;
  } else if constexpr (BODY == kBitwise) {
    return (c | 1u) & 0xFFFFFFFEu;
  } else if constexpr (BODY == kMixed7) {
    // 7 ops: 2 mul, 2 add, 2 shift, 1 or
    const uint32_t d = sra(c, 1) + (c << 1);
    const uint32_t e = c * (c | 1u);
    return d + e * c;
  } else if constexpr (BODY == kStageMix10) {
    // 10 ops: 2 mul, 4 add/sub, 3 shift, 1 and
    const uint32_t d = sra(c, 1) + (c << 1);
    const uint32_t e = sra(c * (c & 0xFFFFFFFEu), 2);
    const uint32_t f = (d - e) + c * e;
    return f + d;
  } else if constexpr (BODY == kSelect) {
    // 3 ops: compare and the two arms
    return static_cast<int32_t>(c) > 0 ? c + 1u : c - 1u;
  } else if constexpr (BODY == kRoll) {
    // 2 ops: the value of the lane before this one, plus one
    const int lane = threadIdx.x & 31;
    return __shfl_sync(0xFFFFFFFFu, c, (lane + 31) & 31) + 1u;
  } else {
    // kAddPacked: two int16 lanes of one register, each wrapping
    return __vadd2(c, c);
  }
}

// T is the storage type: uint32_t, or uint16_t for the int16 chain, whose
// value is wrapped to 16 bits at every iteration as int16 arithmetic does.
template <int BODY, typename T>
__global__ void __launch_bounds__(kThreads, 4)
chain_kernel(const T* __restrict__ x, T* __restrict__ y, int k) {
  const size_t base =
      static_cast<size_t>(blockIdx.x) * kIlp * kThreads + threadIdx.x;
  uint32_t c[kIlp];
#pragma unroll
  for (int j = 0; j < kIlp; ++j) c[j] = x[base + j * kThreads];
#pragma unroll 1
  for (int i = 0; i < k; ++i) {
#pragma unroll
    for (int j = 0; j < kIlp; ++j) {
      c[j] = body<BODY>(c[j]);
      if constexpr (sizeof(T) == 2) c[j] = static_cast<T>(c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kIlp; ++j) y[base + j * kThreads] = static_cast<T>(c[j]);
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const int4* __restrict__ x, int4* __restrict__ y, size_t n4) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    int4 v = x[i];
    v.x += 1;
    v.y += 1;
    v.z += 1;
    v.w += 1;
    y[i] = v;
  }
}

template <int BODY, typename T>
cudaError_t launch_chain(const void* x, void* y, long long regs, int k,
                         cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(regs / (kThreads * kIlp));
  chain_kernel<BODY, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), k);
  return cudaGetLastError();
}

template <int BODY = 0>
cudaError_t dispatch_chain(int which, const void* x, void* y, long long regs,
                           int k, cudaStream_t stream) {
  if constexpr (BODY > kRoll) {
    return cudaErrorInvalidValue;
  } else {
    if (which == BODY)
      return launch_chain<BODY, uint32_t>(x, y, regs, k, stream);
    return dispatch_chain<BODY + 1>(which, x, y, regs, k, stream);
  }
}

}  // namespace

// One launch of chain_kernel: y = body^k(x) over n elements of elem_size
// bytes (4: int32, every body but kAddPacked; 2: int16, kAdd or
// kAddPacked).  n must fill whole CTAs: a multiple of kThreads * kIlp
// registers (a register holds one element, or two under kAddPacked).
extern "C" int intfft_probe_chain(const void* x, void* y, long long n,
                                  int elem_size, int which, int k, int device,
                                  void* stream) {
  const bool packed = which == kAddPacked;
  const long long regs = packed ? n / 2 : n;
  if (n <= 0 || k < 0 || regs % (kThreads * kIlp) != 0 ||
      (packed && n % 2 != 0) || (elem_size != 4 && elem_size != 2) ||
      (elem_size == 2 && which != kAdd && !packed) ||
      (elem_size == 4 && packed) || which < 0 || which >= kBodies)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed)
    err = launch_chain<kAddPacked, uint32_t>(x, y, regs, k, s);
  else if (elem_size == 2)
    err = launch_chain<kAdd, uint16_t>(x, y, regs, k, s);
  else
    err = dispatch_chain(which, x, y, regs, k, s);
  return static_cast<int>(err);
}

// One launch of copy_kernel: y = x + 1 over n_words int32 words (a multiple
// of 4; both pointers 16-byte aligned), on `ctas` CTAs.
extern "C" int intfft_probe_copy(const void* x, void* y, long long n_words,
                                 int ctas, int device, void* stream) {
  if (n_words <= 0 || n_words % 4 != 0 || ctas < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(y),
      static_cast<size_t>(n_words / 4));
  return static_cast<int>(cudaGetLastError());
}

// Registers (elements, or pairs under kAddPacked) one CTA of chain_kernel
// holds: kThreads * kIlp.
extern "C" int intfft_probe_cta_elems() { return kThreads * kIlp; }

// The card's device-memory peak in bytes per second, from its attributes:
// memory clock (kHz) x 2 transfers per clock x bus width (bits) / 8; on an
// H100 SXM 2 619 000 x 2 x 5120 / 8 = 3.35e12, the data sheet's rate.  The
// bound of every bytes-bound row is held against it, and a copy that reads
// above it was mistimed.  Negative: the CUDA error code, negated.
extern "C" long long intfft_probe_mem_peak(int device) {
  int khz = 0, bits = 0;
  cudaError_t err = cudaDeviceGetAttribute(&khz, cudaDevAttrMemoryClockRate,
                                           device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bits, cudaDevAttrGlobalMemoryBusWidth,
                                 device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return 2LL * khz * 1000 * bits / 8;
}
