// probe_stages.cu -- the per-stage probe of the factor pass, for Hopper
// (sm_90a): what one radix-2 stage costs on the card, by twiddle order,
// beside its arithmetic alone and its data movement alone.
//
// Replaces, on the NVIDIA H100, the two Pallas TPU measurement kernels of
// tools/probe_stages.py:
//   * _loop_kernel (:55, pallas_call at :72): step(tabs, xr, xi) applied K
//     times to an [n, B] int32 tile pair held in fast memory, so that the
//     time difference of two K is one application with load, store and
//     dispatch cancelled -> stage_loop_kernel<STEP, P, V, kT, LAYOUT>;
//   * _once_kernel (:87, pallas_call at :99): step applied once, to hold a
//     variant against the production stage bit for bit on the device before
//     its time is believed -> stage_once_kernel<STEP, P, V, kT, LAYOUT>.
//
// What they compute.  x and y are [rows, cols] planes (re, im).  One CTA
// holds an [rows, TC] tile pair in shared memory, loads it once, applies
// STEP k times with a barrier after each, as a stage loop has it, and
// stores it once: y = STEP^k(x), equal to stage_loop_reference of
// intfftk_tpu_torch/tools/probe_stages.py.  The geometry is the launch's:
// threads per CTA (a template parameter, instantiated at the counts the
// library builds the pass at, INTFFT_THREAD_MASK) and TC, which the
// wrapper takes by default from the pass's own resolution on the card
// (ops/tuning.py: TC 8 and 128 threads at rows = 256 on an H100), or
// fixed at the probe's first tile (256 threads, TC = min(16, 65536 /
// (rows * sizeof V))).  And the tile's layout, a template parameter: the
// pass's (rows padded to TC + 1 words, as fused_pass.cuh lays its tile
// out) or a swizzled one (probe_stages.cuh, SwizzledTile) on which every
// warp access of every step takes one shared-memory wavefront (two for
// the 8-byte words of the int64 tile, one per half-warp), where the
// pass's padded rows put two accesses on a bank whenever a warp spans
// several rows of fewer than 32 words (TC 8: rows 9 words apart).  Application i runs at the width
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
// stages, and cancel in the difference of two k); the shared-memory side
// by the wavefronts a warp access takes, which the layout sets: the
// swizzled layout reaches the least, at about seven integer operations of
// address per access.  What the design does
// about the compiler: inputs come from memory and differ per thread, the
// result is stored, the k loop is "#pragma unroll 1" and k is a kernel
// argument, so nothing folds across applications; tools/audit_sass.py
// prints each loop's instruction count beside its time.

#include "probe_stages.cuh"

#ifndef INTFFT_THREAD_MASK
#error "compile with -DINTFFT_THREAD_MASK=the thread counts the library holds"
#endif

namespace {

using intfft::StepKernels;

constexpr int kMaxDevices = 64;  // devices a process may launch on

// The most dynamic shared memory one CTA may take on `device` (232 448
// bytes on an H100); 0 where it cannot be read.
int smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return bytes;
}

// The tables of the instantiations at kT threads per CTA, the round-trip
// and register steps (part 0) and the group steps (part 1).
template <int kT>
const StepKernels* step_table(int part, int* count) {
  if constexpr (kT == 128) {
    return part ? intfft::probe_group_steps_t128(count)
                : intfft::probe_round_steps_t128(count);
  } else if constexpr (kT == 256) {
    return part ? intfft::probe_group_steps_t256(count)
                : intfft::probe_round_steps_t256(count);
  } else if constexpr (kT == 512) {
    return part ? intfft::probe_group_steps_t512(count)
                : intfft::probe_round_steps_t512(count);
  } else {
    return part ? intfft::probe_group_steps_t1024(count)
                : intfft::probe_round_steps_t1024(count);
  }
}

bool in_registers(int step) { return step == kArith6 || step == kArith12; }

// The instantiation of (step, order, wide, layout) at the kT among the
// library's thread counts (INTFFT_THREAD_MASK) that equals `threads`; null
// where none does.  A register step keeps no tile: any layout takes its
// one kernel.
template <int kT = 128>
const StepKernels* find_step(int threads, int step, int order, int wide,
                             int layout) {
  if constexpr (kT > 1024) {
    return nullptr;
  } else {
    if constexpr ((INTFFT_THREAD_MASK & (kT / 128)) != 0) {
      if (threads == kT) {
        const int want = in_registers(step) ? intfft::kLayoutPass : layout;
        for (int part = 0; part < 2; ++part) {
          int n = 0;
          const StepKernels* t = step_table<kT>(part, &n);
          for (int i = 0; i < n; ++i) {
            if (t[i].step == step && t[i].order == order &&
                t[i].wide == wide && t[i].layout == want) {
              return &t[i];
            }
          }
        }
        return nullptr;
      }
    }
    return find_step<kT * 2>(threads, step, order, wide, layout);
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// The dynamic shared memory of a step's CTA: the two planes of the tile
// and, for kTwSmem, the order's staged twiddles.
size_t tile_smem(int step, int order, int rows, int tc, int wide,
                 int layout) {
  if (in_registers(step)) return 0;
  return 2u * plane_elems(rows, tc, layout) * (wide ? 8u : 4u) +
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

// A launch geometry the probe takes: the instantiation at `threads`, a
// tile of tc columns (a power of two) that fits the card's shared memory
// per CTA, and on the swizzled layout a tc in swizzle_ok's range.  The
// register steps take a whole number of their trips per tile.  Returns
// the step's kernels, or null.
const StepKernels* geometry_ok(int step, int order, int wide, int rows,
                               int tc, int threads, int layout, int device) {
  const StepKernels* s = find_step(threads, step, order, wide, layout);
  if (s == nullptr || !shape_ok(step, order, rows) || tc < 1 ||
      log2_exact(tc) < 0 ||
      (layout != intfft::kLayoutPass && layout != intfft::kLayoutSwizzle) ||
      (layout == intfft::kLayoutSwizzle && !in_registers(step) &&
       !intfft::swizzle_ok(tc, wide ? 8 : 4)) ||
      (in_registers(step) && (rows * tc) % (threads * kIlp) != 0) ||
      tile_smem(step, order, rows, tc, wide, layout) >
          static_cast<size_t>(smem_optin(device))) {
    return nullptr;
  }
  return s;
}

}  // namespace

// How many CTAs of a step's kernel one SM holds at once (the occupancy the
// runtime computes for stage_loop_kernel) at a geometry: rows of the tile,
// tc columns per CTA, threads per CTA (one of the counts the library holds:
// INTFFT_THREAD_MASK; any other is refused, never clamped), the layout (0
// the pass's, rows padded to tc + 1 words; 1 swizzled), so that the caller
// can choose a width that fills the card.  wide: 1 for the int64 tile.
// Returns a cudaError_t.
extern "C" int intfft_stage_probe_geometry(int step, int order, int wide,
                                           int rows, int tc, int threads,
                                           int layout, int device,
                                           int* ctas_per_sm) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StepKernels* s =
      geometry_ok(step, order, wide, rows, tc, threads, layout, device);
  if (s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile_smem(step, order, rows, tc, wide, layout);
  err = cudaFuncSetAttribute(s->loop,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, s->loop, threads, smem));
}

// Where element (r, c) of a [rows, tc] tile lies in one plane of shared
// memory, for every r and c: out[r * tc + c], in elements of 4 bytes (or
// 8: wide).  Layout 0 the pass's, 1 the swizzled one (swizzle_ok's range
// only).  The map the kernels address the tile with, for the host to
// check.  Returns a cudaError_t.
extern "C" int intfft_stage_probe_tile(int layout, int rows, int tc,
                                       int wide, int* out) {
  const int word = wide ? 8 : 4;
  if (rows < 1 || tc < 1 || log2_exact(tc) < 0 ||
      (layout != intfft::kLayoutPass &&
       (layout != intfft::kLayoutSwizzle || !intfft::swizzle_ok(tc, word))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int swz = intfft::swizzle_table(tc, word);
  const int lt = log2_exact(tc), ll = wide ? 4 : 5;
  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < tc; ++c) {
      const int e = r * tc + c, l = e >> ll;
      const int s = ((swz >> ((l & 7) << 2)) & 15) << lt;
      out[e] = layout == intfft::kLayoutPass ? r * (tc + 1) + c
                                             : e ^ s ^ (l & (tc - 1));
    }
  }
  return 0;
}

// One launch: y = STEP^k(x) over [rows, cols] planes of int32 (wide: int64)
// elements, cols a multiple of tc, at a geometry intfft_stage_probe_geometry
// takes; once: 1 launches stage_once_kernel (one application, k not read).
// w_re/w_im: the packed stage tables [rows] (kProd, kShfl); e_re/e_im: an
// [rows, tc] table (kEpi); the others may be null.  kProdUnscaled and
// kGroupUnscaled* take scale = 0, kProdRound and kGroupRound* scale =
// round = 1.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int intfft_stage_probe(const void* x_re, const void* x_im,
                                  void* y_re, void* y_im, const void* w_re,
                                  const void* w_im, const void* e_re,
                                  const void* e_im, int rows, int cols,
                                  int step, int order, int wide, int k,
                                  int once, int data_width, int scale,
                                  int round, int tw_shift, int tc,
                                  int threads, int layout, int device,
                                  void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StepKernels* s =
      geometry_ok(step, order, wide, rows, tc, threads, layout, device);
  if (s == nullptr || cols < 1 || cols % tc != 0 || k < 0 ||
      data_width < 1 ||
      data_width + (1 - scale) * step_stages(step) * (once ? 1 : k) >
          (wide ? 64 : 32) ||
      (reads_stage_tables(step) && w_re == nullptr) ||
      (step_unscaled(step) && scale) ||
      (step_round(step) && !(scale && round)) ||
      (step == kEpi && e_re == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  PassParams p{1, rows, cols, log2_exact(rows), tc, log2_exact(tc),
               data_width, scale, round, tw_shift, 0, 0, 0, 0};
  const size_t smem = tile_smem(step, order, rows, tc, wide, layout);
  const void* kernel = once ? s->once : s->loop;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int swz = intfft::swizzle_ok(tc, wide ? 8 : 4)
                ? intfft::swizzle_table(tc, wide ? 8 : 4)
                : 0;
  void* args[] = {&x_re, &x_im, &y_re, &y_im, &w_re, &w_im,
                  &e_re, &e_im, &p,    &k,    &swz};
  err = cudaLaunchKernel(kernel, dim3(cols / tc), dim3(threads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
