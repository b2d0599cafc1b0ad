// fused_pass.cuh -- the factor pass kernel of the integer FFT as a template
// (fused_pass_kernel), its launch, and the twiddle synthesis it shares with
// the generator kernel.  What it replaces, computes and is bounded by stands
// at the head of fused_pass.cu, which holds the C interface.
//
// The kernel is instantiated for four pairs of block types, two directions,
// (on the int32 tile) the 1-D and 2-D stage tables and the two forms of the
// complex product (exact, or modulo the tile's word, 2^32 or 2^64: kMod,
// ProductOf): twenty-four kernels, each with a body for every shape of
// stage group.  One source with all of them compiles for 40 s on the card's
// machine; so fused_pass_inst.cu, which includes this header and defines
// one launch_pass_* function, is compiled once for each pair of block
// types and direction, and the build runs the eight compilations side by
// side.  What crosses from one object to another has external linkage
// (namespace intfft); everything else is internal to each.

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

// The convolution's edges (OverlapSaveConv): a pass whose first load reads
// the signal itself (kEdgeWindow) or whose last store writes the
// convolution's output itself (kEdgeCut), where the plain pass reads and
// writes [batch, rows, cols] blocks.  Block b of the batch is payload j = b
// mod blocks of signal row s = b div blocks, and its flat position q lies at
// s * blocks * payload + j * payload - lead + q of the signal (the window:
// zero where j * payload - lead + q < 0) or of the output (the cut: stored
// only where q >= lead).  lead and payload are whole rows (multiples of
// cols), so both predicates are on the row.  first: the batch index of the
// launch's first item (a batch of more than 65 535 items takes several
// launches).  kind kEdgeNone: no edge; the other fields are not read.
constexpr int kEdgeNone = 0, kEdgeWindow = 1, kEdgeCut = 2;
struct EdgeParams {
  int kind, blocks, payload, lead, first;
};

// The one edge a kernel of these element sizes (x, y), direction and
// product form is instantiated with besides kEdgeNone: the window of the
// convolution's int32 forward with exact products, the cut of its int64
// inverse with products modulo 2^64; kEdgeNone for every other form.
__host__ __device__ constexpr int edge_form(int in_size, int out_size,
                                            bool inverse, bool mod) {
  return in_size == 4 && out_size == 4 && !inverse && !mod   ? kEdgeWindow
         : in_size == 8 && out_size == 8 && inverse && mod ? kEdgeCut
                                                           : kEdgeNone;
}

// One pass in one direction on blocks of one pair of element types (x, y):
// int16 -> int16 and int32 -> int32 on the int32 tile, int32 -> int64 (the
// widening pass) and int64 -> int64 on the int64 tile, with kT threads per
// CTA and p.tc columns per CTA; each instantiated by one compilation of
// fused_pass_inst.cu, for one thread count.  The launch takes `smem` bytes
// of dynamic shared memory per CTA, which the grant below has allowed on
// the current device, and adds the kernel launches it made to *launches.
// kMod: the kernel that forms its complex product-sums modulo the tile's
// word, 2^32 or 2^64 (ProductOf).  edge: the convolution's edge the pass
// takes (EdgeParams; kind kEdgeNone for a plain pass).
#define INTFFT_LAUNCH_PASS(NAME)                                              \
  cudaError_t NAME(const PassPtrs& a, const PassParams& p,                    \
                   const SynthParams& syn, const EdgeParams& edge,            \
                   size_t smem, cudaStream_t stream, int* launches)
// Allows the kernel of that pass (two_d: the form with 2-D stage tables;
// skew: the forward's form on the skewed tile, pass_skew; edge: the form
// with that edge, edge_form) `smem` bytes of dynamic shared memory per CTA
// on `device`, the current device: the cudaFuncSetAttribute a launch
// needs, made once per size.
#define INTFFT_GRANT_PASS(NAME)                                               \
  cudaError_t NAME(bool two_d, bool skew, int edge, size_t smem, int device)
// What the compiled kernel of that pass takes: out[0] registers per
// thread, out[1] bytes of local memory per thread (spills), out[2] the most
// threads per CTA it can be launched with, out[3] the CTAs an SM holds with
// `smem` bytes of dynamic shared memory each.  two_d: the form with 2-D
// stage tables (int32 tile only); skew: the form on the skewed tile
// (forward, 1-D tables only); edge: the form with that edge (edge_form).
#define INTFFT_QUERY_PASS(NAME)                                               \
  cudaError_t NAME(bool two_d, bool skew, int edge, size_t smem, int device, \
                   int* out)
#define INTFFT_PASS_FUNCTIONS(BLOCKS, DIR)                                    \
  template <int kT, bool kMod>                                                \
  INTFFT_LAUNCH_PASS(launch_pass_##BLOCKS##_##DIR);                           \
  template <int kT, bool kMod>                                                \
  INTFFT_GRANT_PASS(grant_pass_##BLOCKS##_##DIR);                             \
  template <int kT, bool kMod>                                                \
  INTFFT_QUERY_PASS(query_pass_##BLOCKS##_##DIR)
INTFFT_PASS_FUNCTIONS(i16, fwd);
INTFFT_PASS_FUNCTIONS(i16, inv);
INTFFT_PASS_FUNCTIONS(i32, fwd);
INTFFT_PASS_FUNCTIONS(i32, inv);
INTFFT_PASS_FUNCTIONS(i32_i64, fwd);
INTFFT_PASS_FUNCTIONS(i32_i64, inv);
INTFFT_PASS_FUNCTIONS(i64, fwd);
INTFFT_PASS_FUNCTIONS(i64, inv);

}  // namespace intfft

namespace {

using intfft::EdgeParams;
using intfft::kEdgeCut;
using intfft::kEdgeNone;
using intfft::kEdgeWindow;
using intfft::PassPtrs;
using intfft::SynthParams;

constexpr int kCoarse = 512;     // entries of the coarse quarter table
constexpr int kMaxGridY = 65535; // the most items one launch takes
constexpr int kMaxDevices = 64;  // devices a process may launch on

// The skewed tile (ops/tuning.py, tile_skew).  The forward's store in
// natural order, turned, reads stored row k of a column from tile row
// bitrev(k): 32 lanes, 32 consecutive k, take rows 2^(log_rows - 5) apart,
// which at any pitch fall in one bank (a 32-way conflict at 4096 rows, 8-way
// at 256).  Such a pass lays row r at r * (tc + 1) + (r >> s) words, one
// word more every 2^s rows, s = max(log_rows - 5, 5): the 32 rows of one
// store then reach 32 banks at every TC from 2, and the skew is one value
// over every aligned 32 rows, so an access along 32 consecutive rows (the
// turned load) keeps the banks it had.  On the int64 tile, whose 8-byte
// access is served a half-warp at a time, the same with 16 lanes: s =
// max(log_rows - 4, 4).  0 (the padded tile) below 64 rows (32 on the int64
// tile), where the rule adds no word.
__host__ __device__ inline int tile_skew(int log_rows, int word) {
  const int lanes = word == 8 ? 4 : 5;
  if (log_rows <= lanes) return 0;
  return log_rows - lanes > lanes ? log_rows - lanes : lanes;
}

// The skew a pass takes: its store turned and in natural order, forward,
// with 1-D stage tables (the 2-D tables' monolithic pass keeps the padded
// tile); 0 for every other pass.
inline int pass_skew(const PassParams& p, int word, bool inverse,
                     bool two_d) {
  return !inverse && !two_d && p.natural && p.transpose_out
             ? tile_skew(p.log_rows, word)
             : 0;
}

// The bytes the skewed tile adds to each plane: room for its largest skew,
// (rows - 1) >> s < 32 words of int32 (16 of int64).  A constant, so that
// the second plane's offset costs the kernel no more than the padded one's.
constexpr int kSkewBytes = 128;

// The dynamic shared memory of one CTA: the two planes of the [rows, tc]
// tile, rows padded to tc + 1 words of `word` bytes and, on the skewed tile
// (skew = s > 0), kSkewBytes more each, and the coarse table of the
// in-kernel epilogue where it synthesizes (ops/tuning.py counts the table
// and the skew always, so that TC depends on neither).
inline size_t pass_smem(int rows, int tc, int word, bool synth, int skew) {
  const size_t plane = static_cast<size_t>(rows) * (tc + 1) * word +
                       (skew > 0 ? kSkewBytes : 0);
  return 2u * plane + (synth ? 2u * kCoarse * sizeof(int32_t) : 0u);
}

// The registers a thread of the pass may take, by tile and direction, and
// so the CTAs per SM that __launch_bounds__ names for kT threads per CTA:
// 64 for the forward on the int32 tile (four CTAs of 256 threads, what the
// 16-column tile of m = 256 has room for), 85 for the inverse (three), 128
// on the int64 tile (two), the caps of 256 threads per CTA, kept at every
// thread count as far as the SM's 65 536 registers allow: at 512 threads
// the inverse and the int64 tile may take 128 (one CTA), at 1024 every form
// 64, and there the inverse and the int64 tile spill.  Both forms of a
// tile's products (kMod) take the same cap: a pass takes the modular form
// where every product keeps bits that fit the word (on the int64 tile
// config 4's inverse, config 2's forward, the 24-bit path's widening pass;
// on the int32 tile the core's scaled 16-bit passes), the exact one
// elsewhere (config 2's inverse, the convolution's unscaled forward).  On
// the int64 tile the exact inverse, in limbs, takes 114 registers and
// spills nothing, the modular one 127 and none at 256 and 512 threads (8
// bytes at 128).
// Where shared memory lets an SM hold fewer CTAs (from m = 1024 up), the
// tile budget of the tuning row decides, at run time.
template <typename V, bool kInverse, int kT>
constexpr int min_ctas() {
  constexpr int cap = sizeof(V) == 8 ? 128 : kInverse ? 85 : 64;
  return 65536 / (kT * cap) > 1 ? 65536 / (kT * cap) : 1;
}

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
  int skew;                       // s of the skewed tile (kSkew)
  bool rev_in, rev_out;           // which side is reordered
  bool synth, epilogue;           // the inter-factor product and its source
  int ow;                         // the factor's output width
  int n_full;                     // the full size the synthesis indexes
};

// The offset in the signal (EdgeParams) of this CTA's item, payload j of
// signal row s, and in `below` the samples of its block before the signal
// row's start, lead - j * payload (none where <= 0).  32-bit but the
// offset (the host holds blocks * payload within int32).  blockIdx.y is
// read by a volatile move, so that each task of the group that reads x
// (the window's first) or stores y (the cut's last) makes them anew and no
// register holds them through the groups: the window's int32 form sits at
// its plain twin's 64 registers.
__device__ __forceinline__ size_t edge_item(const EdgeParams& e, int& below) {
  unsigned y;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  const int b = e.first + static_cast<int>(y);
  const int s = b / e.blocks;
  const int from = (b - s * e.blocks) * e.payload;
  below = e.lead - from;
  return static_cast<size_t>(s) * e.blocks * e.payload + from - e.lead;
}

// The uniform step between a task's rows of a group that does not straddle
// the skew s of the skewed tile: (ld << lo) + 2^(lo - s) where lo >= s, ld
// << lo where lo + R <= s.
template <typename Tin, typename Tout, typename V>
__device__ __forceinline__ int skewed_step(int ld, int lo,
                                           const PassCtx<Tin, Tout, V>& k) {
  return (ld << lo) + (lo >= k.skew ? 1 << (lo - k.skew) : 0);
}

// One group of the pass over the whole tile: R stages (R = 0: none, the
// bypass) of the orders lo .. lo + R - 1 on every task.  The operands come
// from device memory (from_x: rows of x[b, :, col], the inverse's
// bit-reversed load an index on the row) or from the tile, and go to device
// memory (to_y: out[b, k, col], the forward's natural order an index on k)
// or to the tile.  The last group multiplies its registers by the
// inter-factor twiddle of the stored row first.  A thread whose column lies
// past p.cols loads zeros and stores nothing to device memory.  P: the form
// of every complex product, the stages' and the epilogue's (cmult).  kSkew:
// the tile is the skewed one (tile_skew).  There a group whose orders all
// lie at or above s has the uniform step (ld << lo) + 2^(lo - s), one
// wholly below s the padded tile's (the skew is base's alone), and the one
// group that straddles s (lo < s < lo + R; kD = s - lo) steps by ld << lo
// with a word more at each multiple of 2^kD of a (group_load_straddle).
// kEdge (EdgeParams `e`): kEdgeWindow reads x at the item's offset in the
// signal (edge_item) and zeros in the rows r with r * cols below it,
// kEdgeCut stores y at that offset and none of the rows r with r * cols <
// lead.
template <typename Tin, typename Tout, typename V, bool kInverse, bool kTwoD,
          int kT, int R, int kLo, typename P, bool kSkew, int kD, int kEdge>
__device__ __forceinline__ void run_group(const PassCtx<Tin, Tout, V>& k,
                                          const PassParams& p,
                                          const SynthParams& syn,
                                          const EdgeParams& e, int lo_rt,
                                          int in_w0, bool from_x, bool to_y,
                                          bool last) {
  constexpr int N = 1 << R;
  const int lo = kLo < 2 ? kLo : lo_rt;
  const int ld = p.tc + 1;
  const int tasks = (p.rows >> R) << p.log_tc;
  // folded: the factor of the epilogue's twiddles, whose products wrap to
  // the factor's output width
  [[maybe_unused]] const uint32_t f =
      kFolds<V, P> && last && k.epilogue ? fold_factor(p.tw_shift, k.ow)
                                          : 1u;
  for (int u = threadIdx.x; u < tasks; u += kT) {
    int c, k0, base;
    group_rows<R>(u, lo, p, c, k0, base);
    const int col = k.c0 + c;
    const bool live = col < p.cols;
    V xr[N], xi[N];
    if (from_x) {
      size_t item = k.item;
      int below = 0;
      if constexpr (kEdge == kEdgeWindow) item = edge_item(e, below);
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const int row = base + (a << lo);
        const int src = k.rev_in ? (__brev(row) >> k.rev_sh) : row;
        xr[a] = xi[a] = 0;
        if (live && (kEdge != kEdgeWindow || src * p.cols >= below)) {
          const size_t g = item + static_cast<size_t>(src) * p.cols + col;
          xr[a] = k.x_re[g];
          xi[a] = k.x_im[g];
        }
      }
    } else if constexpr (kSkew) {
      const int first = base * ld + (base >> k.skew) + c;
      if constexpr (kD > 0) {
        group_load_straddle<V, R, kD>(k.s_re, k.s_im, first, ld << lo, xr,
                                      xi);
      } else {
        group_load_tile<V, R>(k.s_re, k.s_im, first, skewed_step(ld, lo, k),
                              xr, xi);
      }
    } else {
      group_load_tile<V, R>(k.s_re, k.s_im, base * ld + c, ld << lo, xr, xi);
    }
    stage_group<V, kInverse, kTwoD, R, kLo, P>(xr, xi, lo, k0, in_w0, p,
                                               col, k.w_re, k.w_im, k.t2_re,
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
        if constexpr (kFolds<V, P>) {
          cmult_folded(xr[a], xi[a], fold(wr, f), fold(wi, f), k.ow, xr[a],
                       xi[a]);
        } else {
          cmult<V, P>(xr[a], xi[a], wr, wi, p.tw_shift, k.ow, xr[a], xi[a]);
        }
      }
    }
    if (!kSkew && to_y) {
      if (live) {
        size_t item = k.item;
        [[maybe_unused]] int below;
        if constexpr (kEdge == kEdgeCut) item = edge_item(e, below);
#pragma unroll
        for (int a = 0; a < N; ++a) {
          const int row = base + (a << lo);
          const int kk = k.rev_out ? (__brev(row) >> k.rev_sh) : row;
          if (kEdge == kEdgeCut && kk * p.cols < e.lead) continue;
          const size_t g = item + static_cast<size_t>(kk) * p.cols + col;
          k.y_re[g] = static_cast<Tout>(xr[a]);
          k.y_im[g] = static_cast<Tout>(xi[a]);
        }
      }
    } else if constexpr (kSkew) {
      const int first = base * ld + (base >> k.skew) + c;
      if constexpr (kD > 0) {
        group_store_straddle<V, R, kD>(k.s_re, k.s_im, first, ld << lo, xr,
                                       xi);
      } else {
        group_store_tile<V, R>(k.s_re, k.s_im, first,
                               skewed_step(ld, lo, k), xr, xi);
      }
    } else {
      group_store_tile<V, R>(k.s_re, k.s_im, base * ld + c, ld << lo, xr,
                             xi);
    }
  }
}

// Tin / Tout: the element types of x and y; V: the tile's (int32, or
// int64 for the wide forms); kT: threads per CTA; kMod: the complex
// products modulo the tile's word (ProductOf: the form where every product
// of the pass keeps bits that fit the word; the host chooses it per pass
// and intfft_prepare_pass checks it).  kSkew: the skewed tile (tile_skew),
// instantiated for the forward's 1-D forms alone and launched where
// pass_skew says; every access to the tile, the turned load's, the groups'
// and the turned store's, takes its rows there, since the last group writes
// in place what other threads' store reads.  The registers a thread
// may take are min_ctas's.  A thread with no task in a loop (more threads
// than tasks, or the tail CTA's dead columns) still reaches every barrier:
// no __syncthreads lies inside a loop over tasks.  kEdge: the
// convolution's edge (EdgeParams, edge_form), instantiated for the two
// forms that run it alone, on the padded tile; its first load or last
// store takes the item's offset in the signal (edge_item, run_group).
template <typename Tin, typename Tout, typename V, bool kInverse, bool kTwoD,
          int kT, bool kMod, bool kSkew, int kEdge>
__global__ void __launch_bounds__(kT, (min_ctas<V, kInverse, kT>()))
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
                  const SynthParams syn, const int skew_shift,
                  const EdgeParams edge) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = GroupSize<V>::R;
  V* const smem = reinterpret_cast<V*>(smem_raw);
  const int m = p.rows, tc = p.tc, ld = tc + 1;
  const int skew = kSkew ? skew_shift : 0;
  const int plane =
      kSkew ? m * ld + kSkewBytes / static_cast<int>(sizeof(V)) : m * ld;
  // the coarse table of the in-kernel epilogue lies after the two planes;
  // the int64 tile never synthesizes
  int32_t* const s_cre = reinterpret_cast<int32_t*>(smem + 2 * plane);
  PassCtx<Tin, Tout, V> k;
  k.x_re = x_re, k.x_im = x_im, k.y_re = y_re, k.y_im = y_im;
  k.w_re = w_re, k.w_im = w_im, k.t2_re = t2_re, k.t2_im = t2_im;
  k.e_re = e_re, k.e_im = e_im;
  k.s_cre = s_cre, k.s_cim = s_cre + kCoarse;
  k.s_re = smem, k.s_im = smem + plane;
  k.item = static_cast<size_t>(blockIdx.y) * m * p.cols;
  k.c0 = blockIdx.x * tc;
  k.rev_sh = 32 - p.log_rows;
  k.skew = skew;
  // which side is reordered: the inverse's load, the forward's store
  k.rev_in = kInverse && p.natural;
  k.rev_out = kSkew || (!kInverse && p.natural);
  k.synth = sizeof(V) == 4 && c_re != nullptr;
  k.epilogue = e_re != nullptr || k.synth;
  const int gain = 1 - p.scale;
  k.ow = p.data_width + p.log_rows * gain;
  k.n_full = 1 << syn.log_n;
  const int tile = m * tc;

  // a [B, C, R] operand is read along R into the tile: consecutive lanes
  // read consecutive addresses; the tail tile reads zeros
  if (p.transpose_in) {
    for (int u = threadIdx.x; u < tile; u += kT) {
      const int r = u & (m - 1), c = u >> p.log_rows, col = k.c0 + c;
      V vr = 0, vi = 0;
      if (col < p.cols) {
        const size_t g = k.item + static_cast<size_t>(col) * m + r;
        vr = x_re[g];
        vi = x_im[g];
      }
      const int row = k.rev_in ? (__brev(r) >> k.rev_sh) : r;
      const int a = kSkew ? row * ld + (row >> skew) + c : row * ld + c;
      k.s_re[a] = vr;
      k.s_im[a] = vi;
    }
  }
  if (k.synth) {
    for (int u = threadIdx.x; u < kCoarse; u += kT) {
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
    const bool to_y = !kSkew && last && !p.transpose_out;
    // the forward's first group holds the top orders (lo >= 2) and its
    // last one order 0: a modular skewed kernel compiles the read of x and
    // the epilogue into those groups' bodies alone, which keeps it within
    // its registers (the exact forms spilled more so, and keep both)
    constexpr bool kTrim = kSkew && kMod;
#define RUN_GROUP(GR, GLO, GD)                                                \
  run_group<Tin, Tout, V, kInverse, kTwoD, kT, GR, GLO, ProductOf<V, kMod>, \
            kSkew, GD, kEdge>(k, p, syn, edge, lo, in_w0,                    \
                       from_x && (!kTrim || GLO == 2 || GR == 0), to_y,      \
                       last && (!kTrim || GLO == 0))
    if (r == R) {
      if (lo >= 2) {
        // on the skewed tile the one group that straddles s (lo < s < lo +
        // R, only ever a full group at lo >= 2, since s >= 4) is a body of
        // its own, its skew an immediate of each access
        if constexpr (kSkew) {
          if (skew == lo + 1) {
            RUN_GROUP(R, 2, 1);
          } else if (R > 2 && skew == lo + 2) {
            RUN_GROUP(R, 2, 2);
          } else {
            RUN_GROUP(R, 2, 0);
          }
        } else {
          RUN_GROUP(R, 2, 0);
        }
      } else if (lo == 1) {
        RUN_GROUP(R, 1, 0);
      } else {
        RUN_GROUP(R, 0, 0);
      }
    } else if (r == 2) {
      if constexpr (R > 2) RUN_GROUP(2, 0, 0);
    } else if (r == 1) {
      if constexpr (R > 1) RUN_GROUP(1, 0, 0);
    } else {
      RUN_GROUP(0, 0, 0);
    }
#undef RUN_GROUP
    if (!to_y) __syncthreads();
  }

  // out[b, col, k]: m contiguous values per column, read from the tile
  // along k (stored row k lives at tile row bitrev(k) in the natural
  // forward, at row k otherwise; on the skewed tile 32 consecutive k reach
  // 32 banks)
  if (kSkew || p.transpose_out) {
    for (int u = threadIdx.x; u < tile; u += kT) {
      const int kk = u & (m - 1), c = u >> p.log_rows, col = k.c0 + c;
      if (col < p.cols) {
        const int row = k.rev_out ? (__brev(kk) >> k.rev_sh) : kk;
        const int a = kSkew ? row * ld + (row >> skew) + c : row * ld + c;
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

// Raises the dynamic shared memory this kernel may use on `device` (the
// current device) to `smem` when a prepared pass (or a query) needs more
// than any before it, not on every launch.  One cache per instantiation:
// each thread count is a kernel of its own.
template <typename Tin, typename Tout, typename V, bool kInverse, bool kTwoD,
          int kT, bool kMod, bool kSkew, int kEdge>
cudaError_t grant_smem(int device, size_t smem) {
  static size_t granted[kMaxDevices] = {};
  if (smem <= granted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_pass_kernel<Tin, Tout, V, kInverse, kTwoD, kT, kMod, kSkew,
                        kEdge>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) granted[device] = smem;
  return err;
}

// The launch of p.tc columns and kT threads per CTA, with `smem` bytes of
// dynamic shared memory per CTA, granted by the prepare step.  TC and the
// thread count come from the host (ops/tuning.py: the card's row, or a
// plan's override), and the prepare step has checked them: nothing here
// clamps.  Sixteen int16 columns are one 32-byte sector per row; a narrower
// tile reads shorter row segments and lets an SM hold more CTAs at large m.
// The side of an edge (kEdge) is not sliced by item: each launch tells the
// kernel its first item instead (EdgeParams::first).
template <typename Tin, typename Tout, typename V, bool kInverse, bool kTwoD,
          int kT, bool kMod, bool kSkew, int kEdge>
cudaError_t launch(const PassPtrs& a, const PassParams& p,
                   const SynthParams& syn, const EdgeParams& edge,
                   size_t smem, cudaStream_t stream, int* launches) {
  const auto kernel = fused_pass_kernel<Tin, Tout, V, kInverse, kTwoD, kT,
                                        kMod, kSkew, kEdge>;
  const auto i32 = [](const void* v) {
    return static_cast<const int32_t*>(v);
  };
  const unsigned tiles = (p.cols + p.tc - 1) / p.tc;
  cudaError_t err = cudaSuccess;
  const size_t item = static_cast<size_t>(p.rows) * p.cols;
  // gridDim.y holds at most kMaxGridY items: a larger batch takes several
  // launches, each on its own slice of x and y and each counted
  for (int b0 = 0; b0 < p.batch; b0 += kMaxGridY) {
    const int nb = p.batch - b0 < kMaxGridY ? p.batch - b0 : kMaxGridY;
    const size_t off = static_cast<size_t>(b0) * item;
    const size_t x_off = kEdge == kEdgeWindow ? 0 : off;
    const size_t y_off = kEdge == kEdgeCut ? 0 : off;
    EdgeParams e = edge;
    e.first = b0;
    kernel<<<dim3(tiles, nb), kT, smem, stream>>>(
        static_cast<const Tin*>(a.x_re) + x_off,
        static_cast<const Tin*>(a.x_im) + x_off, i32(a.w_re), i32(a.w_im),
        i32(a.t2_re), i32(a.t2_im), i32(a.e_re), i32(a.e_im), i32(a.c_re),
        i32(a.c_im), static_cast<Tout*>(a.y_re) + y_off,
        static_cast<Tout*>(a.y_im) + y_off, p, syn,
        pass_skew(p, sizeof(V), kInverse, kTwoD), e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

template <typename Tin, typename Tout, typename V, bool kInverse, bool kTwoD,
          int kT, bool kMod, bool kSkew, int kEdge>
cudaError_t query(size_t smem, int device, int* out) {
  const auto kernel = fused_pass_kernel<Tin, Tout, V, kInverse, kTwoD, kT,
                                        kMod, kSkew, kEdge>;
  cudaError_t err =
      grant_smem<Tin, Tout, V, kInverse, kTwoD, kT, kMod, kSkew, kEdge>(
          device, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = attr.maxThreadsPerBlock;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, kT,
                                                       smem);
}

// The 2-D stage tables are a template parameter, as the direction is, so
// the standard stages carry no branch of the other forms; so is the skewed
// tile, which only the forward's 1-D forms have (pass_skew), and so is the
// convolution's edge, which only edge_form's two forms have, with 1-D
// tables on the padded tile.  The int64 tile has no 2-D form (the caller
// checks).
template <typename Tin, typename Tout, bool kInverse, bool kMod>
constexpr int kEdgeOf =
    intfft::edge_form(sizeof(Tin), sizeof(Tout), kInverse, kMod);

template <typename Tin, typename Tout, typename V, bool kInverse, int kT,
          bool kMod>
cudaError_t launch_tables(const PassPtrs& a, const PassParams& p,
                          const SynthParams& syn, const EdgeParams& edge,
                          size_t smem, cudaStream_t stream, int* launches) {
  constexpr int kEdge = kEdgeOf<Tin, Tout, kInverse, kMod>;
  if (edge.kind != kEdgeNone) {
    if constexpr (kEdge != kEdgeNone) {
      if (edge.kind == kEdge && a.t2_re == nullptr &&
          pass_skew(p, sizeof(V), kInverse, false) == 0) {
        return launch<Tin, Tout, V, kInverse, false, kT, kMod, false, kEdge>(
            a, p, syn, edge, smem, stream, launches);
      }
    }
    return cudaErrorInvalidValue;
  }
  if constexpr (sizeof(V) == 4) {
    if (a.t2_re != nullptr) {
      return launch<Tin, Tout, V, kInverse, true, kT, kMod, false,
                    kEdgeNone>(a, p, syn, edge, smem, stream, launches);
    }
  }
  if constexpr (!kInverse) {
    if (pass_skew(p, sizeof(V), kInverse, false) > 0) {
      return launch<Tin, Tout, V, kInverse, false, kT, kMod, true,
                    kEdgeNone>(a, p, syn, edge, smem, stream, launches);
    }
  }
  return launch<Tin, Tout, V, kInverse, false, kT, kMod, false, kEdgeNone>(
      a, p, syn, edge, smem, stream, launches);
}

template <typename Tin, typename Tout, typename V, bool kInverse, int kT,
          bool kMod>
cudaError_t grant_tables(bool two_d, bool skew, int edge, size_t smem,
                         int device) {
  constexpr int kEdge = kEdgeOf<Tin, Tout, kInverse, kMod>;
  if (edge != kEdgeNone) {
    if constexpr (kEdge != kEdgeNone) {
      if (edge == kEdge && !two_d && !skew) {
        return grant_smem<Tin, Tout, V, kInverse, false, kT, kMod, false,
                          kEdge>(device, smem);
      }
    }
    return cudaErrorInvalidValue;
  }
  if constexpr (sizeof(V) == 4) {
    if (two_d && !skew) {
      return grant_smem<Tin, Tout, V, kInverse, true, kT, kMod, false,
                        kEdgeNone>(device, smem);
    }
  }
  if constexpr (!kInverse) {
    if (skew && !two_d) {
      return grant_smem<Tin, Tout, V, kInverse, false, kT, kMod, true,
                        kEdgeNone>(device, smem);
    }
  }
  if (two_d || skew) return cudaErrorInvalidValue;
  return grant_smem<Tin, Tout, V, kInverse, false, kT, kMod, false,
                    kEdgeNone>(device, smem);
}

template <typename Tin, typename Tout, typename V, bool kInverse, int kT,
          bool kMod>
cudaError_t query_tables(bool two_d, bool skew, int edge, size_t smem,
                         int device, int* out) {
  constexpr int kEdge = kEdgeOf<Tin, Tout, kInverse, kMod>;
  if (edge != kEdgeNone) {
    if constexpr (kEdge != kEdgeNone) {
      if (edge == kEdge && !two_d && !skew) {
        return query<Tin, Tout, V, kInverse, false, kT, kMod, false, kEdge>(
            smem, device, out);
      }
    }
    return cudaErrorInvalidValue;
  }
  if constexpr (sizeof(V) == 4) {
    if (two_d && !skew) {
      return query<Tin, Tout, V, kInverse, true, kT, kMod, false, kEdgeNone>(
          smem, device, out);
    }
  }
  if constexpr (!kInverse) {
    if (skew && !two_d) {
      return query<Tin, Tout, V, kInverse, false, kT, kMod, true, kEdgeNone>(
          smem, device, out);
    }
  }
  if (two_d || skew) return cudaErrorInvalidValue;
  return query<Tin, Tout, V, kInverse, false, kT, kMod, false, kEdgeNone>(
      smem, device, out);
}

}  // namespace
