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
//     inter-factor twiddle and a transposed store, then factor 2 (the
//     split form; its one-launch form, a thread-block cluster per item, is
//     fused_whole.cuh);
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
// wraps, the product-sums, index math) fills the SM's integer pipes long
// before the bytes fill the memory system.  Run one stage at a time through
// the tile, that work was not even the limit: each butterfly's loads,
// products and stores waited on each other with nothing else in flight, and
// three more passes over the tile (load, epilogue, store) and ten barriers
// per launch stood around the stages.  From m = 1024 up a CTA's tile takes
// most of an SM's shared memory, so an SM holds one CTA: its threads per
// CTA are then all the warps the SM has to hide the groups' latency with.
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
// columns: [m, TC] re and im planes, rows padded to TC + 1 words.  TC and
// the threads per CTA (a template parameter) come from the card's tuning
// row (ops/tuning.py), chosen by a sweep of the card-bound paths
// (tools/sweep_tuning.py): on an H100 at most 8 columns and two tasks of a
// group per thread, up to 512 threads, so that an SM holding one CTA of an
// m = 4096 tile runs 16 warps where it ran 8.  The
// direction, the 2-D tables, the size of a group and whether its lowest
// order is 0, 1 or a multiplying one are template parameters, so no stage
// carries a branch of another form; the mode (scale, rounding) stays a
// run-time value, because fixing it at compile time bought the group under
// 5 % in the per-stage probe and would double the kernels to build.
//
// Numerics: the arithmetic of intfft_arith.cuh (modular sums wrapped to the
// stage's width, product-sums floor-shifted and wrapped), applied
// stage by stage inside a group exactly as one stage at a time applied it:
// the bits are the same by construction, and every form is held equal to
// its plain version on the card.  The tile type is a template parameter.
// An int64 tile holds twice the bytes: TC halves from m = 512 on (TC = 2 at
// m = 4096, 192 KiB, under the budget of one CTA per SM), and it takes
// neither the in-kernel synthesis nor the 2-D stage tables (the JAX package
// has no wide form of either).  Its complex products are exact in two
// 32-bit limbs a datum (Limbs64: four int32 x int32 -> int64 multiplies a
// sum, no __int128; a floor shift of at most 32), and the int32 tile's in
// 64 bits, unless every product of the pass keeps bits that fit the tile's
// word (the widest wrap w plus the shift s at most 64, or 32;
// product_fits below): then the pass takes the kernel that forms them
// modulo 2^64, or 2^32 (kMod), whose bits are the same; on the int32 tile
// that kernel folds the left shift of each product into the twiddle
// (intfft_arith.cuh), so a sum costs two 32-bit multiplies and one shift.
// Which form a pass takes is the host's choice (ops/fused_fft.product_form),
// made from the widths the plan knows and checked here; it is a template
// parameter, not a run-time branch, and no user sets it.
//
// The batch is the grid's y dimension, which holds at most 65 535 items: a
// larger batch goes out as several launches of that many items each, on
// the same stream.
//
// The convolution's edges (EdgeParams, fused_pass.cuh): overlap-save reads
// overlapping windows of its signal and drops the first M - 1 samples of
// each inverse block.  Run by torch around the chain, the windows (a fill,
// a padded copy, a gathering cast) and the cut (a strided cast) took a
// fifth of config 4's device time at 64 payloads.  Where M - 1 and the
// payload are whole rows of the blocks, the forward's first pass reads the
// windows from the signal (each item's offset in it, zeros before a row's
// start) and the inverse's last pass stores the cut into the output (rows
// past M - 1 only): the same loads and stores with another offset and a
// row predicate, in two instances of their own (edge_form), so that no
// other pass carries a branch of them.
//
// The whole four-step's cluster kernel (fused_whole.cuh) is prepared by
// intfft_prepare_whole (fused_whole.cu) into the same descriptor
// (prepared.cuh), which holds its launch, and goes out through
// intfft_fused_chain like a pass.
//
// Submission: at the 64k path's size a pass takes the card tens of
// microseconds, about what the host took to check, resolve and issue it
// anew on every call, so the host set the pace.  A pass is now checked, resolved and granted its shared memory
// once (intfft_prepare_pass, at a plan's first call with a shape), and a
// plan's call launches all its passes in one C call (intfft_fused_chain),
// which checks only that each descriptor was prepared for this device and
// these tables.  The launches go onto the caller's stream as they are, so
// a CUDA graph captures them (intfftk_tpu_torch/runtime/graph.py).

#include "fused_pass.cuh"
#include "prepared.cuh"

namespace {

// The generator: er/ei[k1, j2] = W_n^(+-k1*j2) for an [n1, n2] table
// (device_circle_table).  Bounded by its bytes: 8 per entry written, about
// 25 integer operations per entry beside them (the data-sheet memory rate
// and the measured integer ceiling put the two within a factor of two of
// each other at 16M entries).  The design keeps every entry's own work at
// the synthesis itself: the row k1 is the grid's (blockIdx.y, and
// gridDim.y further for a table of more rows than a grid has), so m =
// k1 * j2 needs no divide or modulo (m += k1 from one column to the next),
// a thread writes kGenCols = 4 consecutive columns of the row with one
// 16-byte store per plane (scalar stores for a ragged tail, or where n2 or
// the planes are not 16-byte aligned), and the 4 KiB coarse table is staged
// once per CTA in shared memory, as the pass's synthesizing epilogue
// stages it.  The grid (circle_launch) covers the table, a CTA row per
// table row; a grid of whole waves of the card's CTAs, each walking many
// rows, read slower on an H100 (PERF.md).  synth_twiddle is the
// epilogue's, unchanged.
constexpr int kGenThreads = 256, kGenCols = 4;

__global__ void __launch_bounds__(kGenThreads)
circle_table_kernel(const int32_t* __restrict__ cre,
                    const int32_t* __restrict__ cim, int32_t* __restrict__ er,
                    int32_t* __restrict__ ei, int n1, int n2, int inverse,
                    int vec, const SynthParams s) {
  __shared__ int32_t s_c[2 * kCoarse];
  for (int i = threadIdx.x; i < kCoarse; i += blockDim.x) {
    s_c[i] = __ldg(cre + i);
    s_c[kCoarse + i] = __ldg(cim + i);
  }
  __syncthreads();
  const int n = 1 << s.log_n;
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * kGenCols;
  if (j >= n2) return;
  const int cols = n2 - j < kGenCols ? n2 - j : kGenCols;
  for (int k1 = blockIdx.y; k1 < n1; k1 += gridDim.y) {
    int32_t wr[kGenCols], wi[kGenCols];
    int m = k1 * j;                     // < n: the host checks the block
#pragma unroll
    for (int q = 0; q < kGenCols; ++q) {
      if (q < cols) {
        synth_twiddle(inverse ? (n - m) & (n - 1) : m, s_c, s_c + kCoarse,
                      s, wr[q], wi[q]);
        m += k1;
      }
    }
    const size_t g = static_cast<size_t>(k1) * n2 + j;
    if (vec && cols == kGenCols) {
      *reinterpret_cast<int4*>(er + g) = make_int4(wr[0], wr[1], wr[2], wr[3]);
      *reinterpret_cast<int4*>(ei + g) = make_int4(wi[0], wi[1], wi[2], wi[3]);
    } else {
#pragma unroll
      for (int q = 0; q < kGenCols; ++q) {
        if (q < cols) {
          er[g + q] = wr[q];
          ei[g + q] = wi[q];
        }
      }
    }
  }
}

// The generator's launch for an [n1, n2] table (circle_launch of
// ops/twiddle_synth.py is the same rule): threads per CTA, the least power
// of two from 32 to kGenThreads that covers a row's quads of kGenCols
// columns; CTAs along the columns, ceil(quads / threads); along the rows
// one per row, at most kMaxGridY.
struct CircleLaunch {
  int threads, grid_x, grid_y;
};
CircleLaunch circle_launch(int n1, int n2) {
  const int quads = (n2 + kGenCols - 1) / kGenCols;
  int threads = 32;
  while (threads < quads && threads < kGenThreads) threads *= 2;
  return {threads, (quads + threads - 1) / threads,
          n1 < kMaxGridY ? n1 : kMaxGridY};
}

// INTFFT_THREAD_MASK: bit i is set when the library holds the pass at
// 128 << i threads per CTA (nvcc's -D takes no comma, so no list).
#ifndef INTFFT_THREAD_MASK
#error "compile with -DINTFFT_THREAD_MASK=the thread counts the library holds"
#endif

// The pass's launch, grant and query functions of kT threads per CTA, by
// pair of block types, direction and product form (fused_pass_inst.cu
// instantiates them).
using Grant = cudaError_t (*)(bool, bool, int, size_t, int);
using Query = cudaError_t (*)(bool, bool, int, size_t, int, int*);
struct PassFns {
  Launch launch;
  Grant grant;
  Query query;
};
#define INTFFT_FNS(BLOCKS, DIR, MOD)                                          \
  {intfft::launch_pass_##BLOCKS##_##DIR<kT, MOD>,                             \
   intfft::grant_pass_##BLOCKS##_##DIR<kT, MOD>,                              \
   intfft::query_pass_##BLOCKS##_##DIR<kT, MOD>}
#define INTFFT_FORMS(BLOCKS, DIR)                                             \
  { INTFFT_FNS(BLOCKS, DIR, false), INTFFT_FNS(BLOCKS, DIR, true) }
template <int kT>
const PassFns kFns[4][2][2] = {
    {INTFFT_FORMS(i16, fwd), INTFFT_FORMS(i16, inv)},
    {INTFFT_FORMS(i32, fwd), INTFFT_FORMS(i32, inv)},
    {INTFFT_FORMS(i32_i64, fwd), INTFFT_FORMS(i32_i64, inv)},
    {INTFFT_FORMS(i64, fwd), INTFFT_FORMS(i64, inv)}};
#undef INTFFT_FORMS
#undef INTFFT_FNS

// The functions of block form `blocks` (block_form), direction and product
// form (mod: modulo the tile's word) at the kT among the library's thread
// counts (INTFFT_THREAD_MASK) that equals `threads`; null where none does.
// Only the counts the mask names are instantiated.
template <int kT = 128>
const PassFns* pass_fns(int threads, int blocks, int inverse, int mod) {
  if constexpr (kT > 1024) {
    return nullptr;
  } else {
    if constexpr ((INTFFT_THREAD_MASK & (kT / 128)) != 0) {
      if (threads == kT) return &kFns<kT>[blocks][inverse != 0][mod != 0];
    }
    return pass_fns<kT * 2>(threads, blocks, inverse, mod);
  }
}

// Whether every complex product of a pass keeps bits that fit the tile's
// word of `bits` (32 or 64), so that the modular form gives the exact
// form's bits: the widest wrap w of a product plus the shift.  Stage j
// enters at data_width + j * gain bits (gain = 1 - scale) and multiplies
// where its order q is at least 2 (q = j inverse, log_rows - 1 - j
// forward), or at every order with the 2-D tables (two_d), wrapped to its
// input width inverse (DIT) and to its output width forward (DIF): at most
// data_width + (log_rows - 1) * gain inverse, and data_width + (log_rows -
// 2) * gain forward (data_width + log_rows * gain with two_d); the
// epilogue wraps to the factor's output width, data_width + log_rows *
// gain, wider than any stage.  ops/fused_fft.product_form is the same rule.
bool product_fits(int log_rows, int data_width, int scale, int tw_shift,
                  int bypass, int inverse, bool two_d, bool epilogue,
                  int bits) {
  const int gain = 1 - scale;
  const int top = inverse ? log_rows - 1 : two_d ? log_rows : log_rows - 2;
  int w = 0;
  if (!bypass) w = data_width + top * gain;
  if (epilogue) w = data_width + log_rows * gain;
  return w + tw_shift <= bits;
}

// The row of the launch and query tables of a pair of element sizes:
// (2, 2), (4, 4), (4, 8), (8, 8); -1 for any other.
int block_form(int in_size, int out_size) {
  if (in_size == out_size && (in_size == 2 || in_size == 4)) {
    return in_size == 2 ? 0 : 1;
  }
  if (out_size == 8 && (in_size == 4 || in_size == 8)) {
    return in_size == 4 ? 2 : 3;
  }
  return -1;
}

// A synthesis block [rows, cols] of size n = 2^log_n: every index
// k * j < n, and the Taylor regime (stage order log_n - 1 >= 11).
bool synth_ok(const SynthParams& s, int rows, int cols) {
  return s.log_n >= 12 && s.log_n <= 30 && s.sh_cnt >= 0 &&
         s.sh_cnt <= s.log_n - 3 &&
         static_cast<long long>(rows - 1) * (cols - 1) < (1LL << s.log_n);
}

int table_mask(const PassPtrs& a) {
  return (a.w_re != nullptr ? kTableW : 0) |
         (a.t2_re != nullptr ? kTableT2 : 0) |
         (a.e_re != nullptr ? kTableE : 0) | (a.c_re != nullptr ? kTableC : 0);
}

// Pass i's pointers of a chain: 12 per pass, in PassPtrs order.
PassPtrs pass_ptrs(void* const* v) {
  return PassPtrs{v[0], v[1], v[2], v[3], v[4], v[5],
                  v[6], v[7], v[8], v[9], v[10], v[11]};
}

}  // namespace

// Plain C interface, loaded with ctypes (intfftk_tpu_torch/ops/_build.py).
// A pass is prepared once (intfft_prepare_pass: every check, the kernel of
// its form and thread count, the shared-memory grant) and launched on every
// call (intfft_fused_chain: the passes of a plan in one call, no check but
// that each descriptor was prepared on this device for these tables).
// Pointers are device pointers.  Stage tables: w_re/w_im [rows], or, when
// t2_re/t2_im are given, 2-D tables [rows, cols] (w may be null then).
// Epilogue: e_re/e_im [rows, cols], or the coarse table c_re/c_im [512]
// with the synthesis constants, or neither (both null).  in_size and
// out_size are the bytes of an element of x and y: (2, 2) and (4, 4) run
// on the int32 tile with outputs of <= 32 bits; (4, 8), the widening pass,
// and (8, 8) on the int64 tile with outputs of <= 64 bits, no 2-D tables
// and no synthesis.  tc: columns per CTA, a power of two; threads: threads
// per CTA, one of the counts this library was compiled for (the tuning
// row's, ops/tuning.py, or a sweep's variant, ops/_build.py); the tile of
// tc columns must fit the card's shared memory per CTA.  product: the form
// of the complex products, 0 exact (every pass can take it; on the int64
// tile, the limbs, at a twiddle shift of 0 .. kLimbMaxShift), 1 modulo the
// tile's word, 2^32 or 2^64 (where product_fits holds).  What does not is
// refused with cudaErrorInvalidValue, never clamped.

extern "C" int intfft_prepared_size() {
  return static_cast<int>(sizeof(PreparedPass));
}

// Prepares one pass into `desc` (intfft_prepared_size() bytes, 8-byte
// aligned) for `device`: the arguments of intfft_fused_pass but the
// pointers, and `tables`, which of the table pointers every launch will
// give (1 w, 2 t2, 4 e, 8 c).  report[0..4]: TC, threads per CTA, the
// dynamic shared memory of a CTA in bytes, the CTAs along the columns and
// the skew of its tile (pass_skew: s, or 0 for the padded tile).
// product 1 asks for the modular form, refused where product_fits does not
// hold for the tile's word; product 0 on the int64 tile, the limbs, is
// refused at a twiddle shift outside 0 .. kLimbMaxShift.  edge (EdgeParams:
// 0 none, 1 the window, 2 the cut), edge_blocks, edge_payload, edge_lead:
// the convolution's edge, refused where the form has no such kernel
// (edge_form), the tables are 2-D, the tile is skewed, the side of the
// edge is turned (transpose_in for the window, transpose_out for the cut),
// the lead or the payload is no whole number of rows of `cols`, lead +
// payload is not rows * cols or the batch is no whole number of signal
// rows of edge_blocks payloads.  Returns a cudaError_t; `desc` is usable
// only when it is 0.
extern "C" int intfft_prepare_pass(
    int batch, int rows, int cols, int in_size, int out_size, int data_width,
    int scale, int round, int tw_shift, int bypass, int inverse, int natural,
    int transpose_in, int transpose_out, int synth_log_n, int mathpi,
    int xshift, int sh_cnt, int tc, int threads, int product, int edge,
    int edge_blocks, int edge_payload, int edge_lead, int tables, int device,
    void* desc, int* report) {
  auto* d = static_cast<PreparedPass*>(desc);
  d->magic = 0;
  const int log_rows = log2_exact(rows);
  const int log_tc = tc >= 1 && tc <= 1024 ? log2_exact(tc) : -1;
  const SynthParams syn{synth_log_n, mathpi, xshift, sh_cnt};
  const int blocks = block_form(in_size, out_size);
  const bool wide = blocks >= 2;
  const bool two_d = (tables & kTableT2) != 0;
  const bool synth = (tables & kTableC) != 0;
  if (log_rows < 3 || log_rows > 12 || batch < 1 || cols < 1 ||
      data_width < 1 || blocks < 0 || log_tc < 0 ||
      data_width + (1 - scale) * log_rows > (wide ? 64 : 32) ||
      (tables & ~(kTableW | kTableT2 | kTableE | kTableC)) != 0 ||
      (tables & (kTableW | kTableT2)) == 0 ||
      ((tables & kTableE) != 0 && synth) || (wide && (two_d || synth)) ||
      (synth && !synth_ok(syn, rows, cols)) || device < 0 ||
      device >= kMaxDevices || product < 0 || product > 1 ||
      (wide && !product && (tw_shift < 0 || tw_shift > kLimbMaxShift)) ||
      (product && !product_fits(log_rows, data_width, scale, tw_shift,
                                bypass, inverse, two_d,
                                (tables & (kTableE | kTableC)) != 0,
                                wide ? 64 : 32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PassFns* fns = pass_fns(threads, blocks, inverse, product);
  if (fns == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PassParams p{batch,    rows,       cols,  log_rows, tc,
                     log_tc,   data_width, scale, round,    tw_shift,
                     bypass,   natural,    transpose_in,    transpose_out};
  const int skew = pass_skew(p, wide ? 8 : 4, inverse != 0, two_d);
  if (edge != kEdgeNone &&
      (edge != intfft::edge_form(in_size, out_size, inverse != 0,
                                 product != 0) ||
       two_d || skew > 0 ||
       (edge == kEdgeWindow ? transpose_in : transpose_out) ||
       edge_blocks < 1 || edge_payload < 1 || edge_lead < 0 ||
       edge_payload % cols != 0 || edge_lead % cols != 0 ||
       static_cast<long long>(edge_payload) + edge_lead !=
           static_cast<long long>(rows) * cols ||
       batch % edge_blocks != 0 ||
       static_cast<long long>(edge_blocks) * edge_payload > INT32_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = pass_smem(rows, tc, wide ? 8 : 4, synth, skew);
  if (smem > static_cast<size_t>(smem_optin(device))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = fns->grant(two_d, skew > 0, edge, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  d->device = device;
  d->tables = tables;
  d->smem = smem;
  d->launch = fns->launch;
  d->whole = nullptr;
  d->p = p;
  d->syn = syn;
  d->edge = EdgeParams{edge, edge_blocks, edge_payload, edge_lead, 0};
  d->magic = kPrepared;
  report[0] = tc;
  report[1] = threads;
  report[2] = static_cast<int>(smem);
  report[3] = (cols + tc - 1) / tc;
  report[4] = skew;
  return 0;
}

// Launches n_passes prepared passes (descs: an array of them) in order on
// `stream`, on `device`: pass i reads and writes the 12 device pointers
// ptrs[12 i .. 12 i + 11] (x_re, x_im, w_re, w_im, t2_re, t2_im, e_re,
// e_im, c_re, c_im, y_re, y_im), so a plan's input, the intermediate of
// each pass but the last and its output, and the tables.  Before any launch
// every descriptor must have been prepared, on `device`, for exactly the
// table pointers given, with x and y given: else cudaErrorInvalidValue and
// nothing launched.  A batch of more than 65 535 items takes several
// launches.  out[0] receives the kernel launches made.  Returns a
// cudaError_t: 0 when every launch was accepted.
extern "C" int intfft_fused_chain(const void* descs, int n_passes,
                                  void* const* ptrs, int device, void* stream,
                                  int* out) {
  out[0] = 0;
  const auto* d = static_cast<const PreparedPass*>(descs);
  if (d == nullptr || ptrs == nullptr || n_passes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n_passes; ++i) {
    const PassPtrs a = pass_ptrs(ptrs + 12 * i);
    if (d[i].magic != kPrepared || d[i].device != device ||
        d[i].tables != table_mask(a) || a.x_re == nullptr ||
        a.x_im == nullptr || a.y_re == nullptr || a.y_im == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n_passes; ++i) {
    const PassPtrs a = pass_ptrs(ptrs + 12 * i);
    err = d[i].whole != nullptr
              ? d[i].whole(a, d[i].p, d[i].p2, d[i].w, d[i].smem, s, out)
              : d[i].launch(a, d[i].p, d[i].syn, d[i].edge, d[i].smem, s,
                            out);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One pass, prepared and launched in one call: out[0] receives the kernel
// launches made, one for every 65 535 items of the batch or part of them;
// out[1..5] TC, threads per CTA, the dynamic shared memory of a CTA in
// bytes, the CTAs along the columns and the skew of its tile.  Returns a
// cudaError_t: 0 when every launch was accepted.
extern "C" int intfft_fused_pass(
    const void* x_re, const void* x_im, void* y_re, void* y_im,
    const void* w_re, const void* w_im, const void* t2_re, const void* t2_im,
    const void* e_re, const void* e_im, const void* c_re, const void* c_im,
    int batch, int rows, int cols, int in_size, int out_size,
    int data_width, int scale, int round, int tw_shift, int bypass,
    int inverse, int natural, int transpose_in, int transpose_out,
    int synth_log_n, int mathpi, int xshift, int sh_cnt, int tc, int threads,
    int product, int edge, int edge_blocks, int edge_payload, int edge_lead,
    int device, void* stream, int* out) {
  out[0] = 0;
  void* const ptrs[12] = {
      const_cast<void*>(x_re),  const_cast<void*>(x_im),
      const_cast<void*>(w_re),  const_cast<void*>(w_im),
      const_cast<void*>(t2_re), const_cast<void*>(t2_im),
      const_cast<void*>(e_re),  const_cast<void*>(e_im),
      const_cast<void*>(c_re),  const_cast<void*>(c_im),
      y_re,                     y_im};
  PreparedPass d;
  const int err = intfft_prepare_pass(
      batch, rows, cols, in_size, out_size, data_width, scale, round,
      tw_shift, bypass, inverse, natural, transpose_in, transpose_out,
      synth_log_n, mathpi, xshift, sh_cnt, tc, threads, product, edge,
      edge_blocks, edge_payload, edge_lead, table_mask(pass_ptrs(ptrs)),
      device, &d, out + 1);
  if (err != 0) return err;
  return intfft_fused_chain(&d, 1, ptrs, device, stream, out);
}

// What the compiled pass of one form takes at `threads` threads per CTA
// and a tile of `tc` columns of `rows` rows (synth: with the coarse table):
// out[0] registers per thread, out[1] bytes of local memory per thread
// (spills), out[2] the most threads per CTA it launches with, out[3] the
// CTAs an SM holds, out[4] the CTA's dynamic shared memory in bytes.  Forms
// as intfft_fused_pass (in_size, out_size, inverse, two_d: the 2-D stage
// tables, product: 1 the modular product; skew: 1 the forward's form on
// the skewed tile that a pass of these rows storing turned in natural order
// takes, pass_skew; edge: 1 the window, 2 the cut, the convolution's form
// of edge_form).  cudaErrorInvalidValue where this library holds no such
// kernel (a skewed inverse, 2-D or a tile of too few rows; an edge of
// another form, 2-D or skewed) or the tile exceeds the card's shared memory
// per CTA.
extern "C" int intfft_pass_attributes(int in_size, int out_size, int inverse,
                                      int two_d, int rows, int tc,
                                      int threads, int synth, int product,
                                      int skew, int edge, int device,
                                      int* out) {
  const int blocks = block_form(in_size, out_size);
  const int log_rows = log2_exact(rows);
  const int word = blocks >= 2 ? 8 : 4;
  if (blocks < 0 || rows < 1 || tc < 1 || log2_exact(tc) < 0 ||
      device < 0 || device >= kMaxDevices || product < 0 || product > 1 ||
      skew < 0 || skew > 1 ||
      (skew && (inverse || two_d || log_rows < 0 ||
                tile_skew(log_rows, word) == 0)) ||
      (edge != kEdgeNone &&
       (edge != intfft::edge_form(in_size, out_size, inverse != 0,
                                  product != 0) ||
        two_d || skew))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PassFns* fns = pass_fns(threads, blocks, inverse, product);
  if (fns == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = pass_smem(rows, tc, word, synth != 0,
                                skew ? tile_skew(log_rows, word) : 0);
  if (smem > static_cast<size_t>(smem_optin(device))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[4] = static_cast<int>(smem);
  return static_cast<int>(
      fns->query(two_d != 0, skew != 0, edge, smem, device, out));
}

// The [n1, n2] inter-factor table W_n^(+-k*j) from the coarse table
// c_re/c_im [512] (device pointers), written to er/ei [n1, n2]: one launch
// of circle_table_kernel on `stream`, nothing allocated, no host sync
// (so a CUDA graph captures it).  launch[0..2] receives its threads per
// CTA and grid (circle_launch).  Returns a cudaError_t.
extern "C" int intfft_circle_table(const void* c_re, const void* c_im,
                                   void* er, void* ei, int n1, int n2,
                                   int inverse, int log_n, int mathpi,
                                   int xshift, int sh_cnt, int device,
                                   void* stream, int* launch) {
  const SynthParams syn{log_n, mathpi, xshift, sh_cnt};
  if (n1 < 1 || n2 < 1 || !synth_ok(syn, n1, n2) ||
      static_cast<long long>(n1) * n2 > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CircleLaunch l = circle_launch(n1, n2);
  const int vec = n2 % kGenCols == 0 &&
                  reinterpret_cast<uintptr_t>(er) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(ei) % 16 == 0;
  circle_table_kernel<<<dim3(l.grid_x, l.grid_y), l.threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c_re), static_cast<const int32_t*>(c_im),
      static_cast<int32_t*>(er), static_cast<int32_t*>(ei), n1, n2, inverse,
      vec, syn);
  launch[0] = l.threads;
  launch[1] = l.grid_x;
  launch[2] = l.grid_y;
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
