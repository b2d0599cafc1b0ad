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
// 16 MiB, about 10 us at the data-sheet 3.35 TB/s; the kernel takes several
// times that, because the integer work per sample (shifts of the register
// wraps, 64-bit product-sums, index math) fills the SM's integer pipes long
// before the bytes fill the memory system.  Run one stage at a time through
// the tile, that work was not even the limit: each butterfly's loads,
// products and stores waited on each other with nothing else in flight, and
// three more passes over the tile (load, epilogue, store) and ten barriers
// per launch stood around the stages.  At m = 4096 a CTA holds only 4
// columns (160 KiB of shared memory, one CTA per SM), so the [n, B] load
// reads 16-byte row segments.
//
// What the design does about it (fused_pass.cuh, stage_body.cuh): the
// stages run in groups of three in registers (stage_group: a thread holds
// the 8 rows three consecutive stages connect, four independent butterflies
// in flight per stage, 7 twiddles read for 12 butterflies, each a warp-wide
// broadcast), and the tile is exchanged once per group, not once per stage:
// m = 256 is 3 + 3 + 2 stages, m = 4096 four groups of 3, m = 8 one group
// and no exchange.  The shell is fused into the groups: the first group
// reads its rows from device memory (a warp reads consecutive columns of
// one row; the inverse's bit-reversed load is an index on the row), the
// inter-factor product runs on the last group's registers, and the last
// group stores to device memory (natural order an index on the stored
// row).  Only a turned side goes through the tile once more: a [B, C, R]
// operand is read along R into it, a [B, C, R] result written along R from
// it.  At m = 256 that leaves 2 exchanges and 2 barriers per launch (3 with
// a turned side) where there were 11 passes over the tile and 10 barriers.
// One read and one write of device memory per pass, as before.  The
// epilogue's table is a second read of the pass's size; synthesizing it
// trades those bytes for about 25 integer operations per sample, and the
// generator kernel makes the table once per plan instead.  The 2-D stage
// tables of the monolithic pass are read once per stage per sample,
// coalesced along the columns.  One CTA holds one batch item and TC
// columns: [m, TC] re and im planes, rows padded to TC + 1 words.  The
// direction, the 2-D tables, the size of a group and whether its lowest
// order is 0, 1 or a multiplying one are template parameters, so no stage
// carries a branch of another form; the mode (scale, rounding) stays a
// run-time value, because fixing it at compile time bought the group under
// 5 % in the per-stage probe and would double the kernels to build.
//
// Numerics: the arithmetic of intfft_arith.cuh (modular sums wrapped to the
// stage's width, exact product-sums floor-shifted and wrapped), applied
// stage by stage inside a group exactly as one stage at a time applied it:
// the bits are the same by construction, and every form is held equal to
// its plain version on the card.  The tile type is a template parameter.
// An int64 tile holds twice the bytes: TC halves from m = 512 on (TC = 2 at
// m = 4096, 192 KiB), and it takes neither the in-kernel synthesis nor the
// 2-D stage tables (the JAX package has no wide form of either).
//
// The batch is the grid's y dimension, which holds at most 65 535 items: a
// larger batch goes out as several launches of that many items each, on
// the same stream.

#include "fused_pass.cuh"

namespace {

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

// Makes `device` the calling thread's current device unless it is already.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
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
      (c_re != nullptr && !synth_ok(syn, rows, cols)) || device < 0 ||
      device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  PassParams p{batch,    rows,   cols,    log_rows,     0,
               0,        data_width, scale, round,      tw_shift,
               bypass,   natural, transpose_in, transpose_out};
  const PassPtrs a{x_re, x_im, w_re, w_im, t2_re, t2_im, e_re, e_im,
                   c_re, c_im, y_re, y_im};
  // one function per pair of block types and direction, each compiled in
  // an object of its own
  using Launch = cudaError_t (*)(const PassPtrs&, const PassParams&,
                                 const SynthParams&, int, cudaStream_t, int*);
  static const Launch kLaunch[4][2] = {
      {intfft::launch_pass_i16_fwd, intfft::launch_pass_i16_inv},
      {intfft::launch_pass_i32_fwd, intfft::launch_pass_i32_inv},
      {intfft::launch_pass_i32_i64_fwd, intfft::launch_pass_i32_i64_inv},
      {intfft::launch_pass_i64_fwd, intfft::launch_pass_i64_inv}};
  const int blocks = in_size == 2 ? 0 : !wide ? 1 : in_size == 4 ? 2 : 3;
  err = kLaunch[blocks][inverse != 0](a, p, syn, device,
                                      static_cast<cudaStream_t>(stream),
                                      launches);
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
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n1 * n2;
  circle_table_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c_re), static_cast<const int32_t*>(c_im),
      static_cast<int32_t*>(er), static_cast<int32_t*>(ei), n1, n2, inverse,
      syn);
  return static_cast<int>(cudaGetLastError());
}

// The groups the pass runs a factor of 2^log_rows rows in, from the top
// order down: tops[g] and sizes[g] of group g (room for 12 each); wide: 1
// for the int64 tile.  Returns the number of groups.
extern "C" int intfft_group_split(int log_rows, int wide, int* tops,
                                  int* sizes) {
  const int R = wide ? GroupSize<int64_t>::R : GroupSize<int32_t>::R;
  const int n = group_count(log_rows, R);
  for (int g = 0; g < n; ++g) group_of(log_rows, R, g, tops[g], sizes[g]);
  return n;
}

extern "C" const char* intfft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
