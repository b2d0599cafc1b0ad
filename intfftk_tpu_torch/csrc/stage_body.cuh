// stage_body.cuh -- the radix-2 stages of the factor pass on its [rows, tc]
// tile, as functions that fused_pass_kernel (fused_pass.cu) and the per-stage
// probe (probe_stages.cu) both call, so that the probe times and counts the
// code the pass runs and not a copy of it.
//
// What bounds a stage on this card: latency, not issue rate.  Run one stage
// at a time through shared memory (stage_body below: 4 loads, 4 stores, 2
// table reads and a barrier per butterfly, one butterfly in flight per
// thread), a multiplying stage takes three times the bare shared-memory
// round trip and two and a half times its arithmetic, and cutting its
// instructions does not shorten it: the loads, the 64-bit products and the
// stores of one butterfly wait on each other and nothing else is in flight.
//
// What the design does about it: stage_group runs R consecutive stages on
// the 2^R rows they connect, held in registers (R = 3 on the int32 tile: 16
// data registers, four independent butterflies per stage in flight per
// thread).  A task is one column c of the tile and the rows
// base + (a << lo), a = 0 .. 2^R - 1, where the group holds the twiddle
// orders lo .. lo + R - 1: forward (DIF) it runs them from the top order
// down, inverse (DIT) from the bottom up, and order lo + i pairs the values
// whose index a differs in bit i.  A thread reads its 2^R values once, runs
// the R stages with the arithmetic of intfft_arith.cuh (each stage wrapped to
// its own width, as stage_body does: the bits are the same by construction),
// and writes them once: one exchange through shared memory and one barrier
// per group instead of per stage.  A stage of a group reads 2^i distinct
// twiddles (bit i), 2^R - 1 per group against R * 2^(R-1) butterflies, and
// they depend on the rows only: the lanes of a warp that hold the columns of
// one task row read one address.  The groups of a factor are R orders each
// from the top order down, with the remainder (log_rows mod R orders) at
// the bottom (group_of): m = 256 is 3 + 3 + 2, m = 4096 four of 3, m = 8
// one group and no exchange at all.  What bounds a group: the ALU pipe.
// About 31 of a multiplying butterfly's 43 instructions run there, two
// thirds of them the shifts of the register wraps, and the group takes 1.3
// times what that pipe alone would need.
//
// stage_body, one butterfly of one stage in place on the tile, stays for
// the probe's prod_p* steps: the yardstick a group is read against.
//
// The tile is [rows, tc] per plane, rows padded to ld = tc + 1 words; stage
// order q pairs rows i and i + 2^q.  Butterfly u of the tile takes column
// c = u mod tc and pair index t = u / tc: k = t mod 2^q is the twiddle
// index, rows i = (t / 2^q) * 2^(q+1) + k and j = i + 2^q.

#pragma once

#include "intfft_arith.cuh"

namespace intfft {

// The parameters of one pass (external linkage: the sources of the factor
// pass hand it to each other).
struct PassParams {
  int batch, rows, cols;   // x is [batch, rows, cols] ([batch, cols, rows]
                           // with transpose_in)
  int log_rows;            // log2(rows)
  int tc, log_tc;          // columns per CTA
  int data_width;          // width entering stage 0
  int scale;               // 1: scaled (per-stage /2), 0: unscaled
  int round;               // 1: round half up, 0: truncate
  int tw_shift;            // renormalising floor shift of every product
  int bypass;              // 1: no butterflies, reorder only (USE_FLY = 0)
  int natural;             // 1: natural spectrum order, 0: bit-reversed
  int transpose_in;        // 1: x is [batch, cols, rows]
  int transpose_out;       // 1: out is [batch, cols, rows]
};

}  // namespace intfft

namespace {

using intfft::PassParams;

constexpr int kThreads = 256;


// Butterfly u of stage order q on the tile (s_re, s_im), in place; h = 2^q,
// in_w is the width entering the stage, out_w = in_w + 1 - scale the width
// leaving it (the caller forms the three once per stage), c0 the tile's
// first global column.  Forward (DIF): sum and difference, then the
// difference times the stage twiddle at the stage's output width.  Inverse
// (DIT): B times the conjugate twiddle first, wrapped to in_w, then the
// same sum and difference.  The twiddle is w[2^q + k] (w_re/w_im, the
// packed stage tables); orders 0 and 1 multiply by nothing and by -j (+j
// inverse) on the odd index.  With kTwoD every order multiplies, by
// t2[2^q + k, column] (the monolithic schedule's 2-D tables).
template <typename V, bool kInverse, bool kTwoD>
__device__ __forceinline__ void stage_body(
    V* s_re, V* s_im, int u, int q, int h, int in_w, int out_w,
    const PassParams& p, int c0,
    const int32_t* __restrict__ w_re, const int32_t* __restrict__ w_im,
    const int32_t* __restrict__ t2_re, const int32_t* __restrict__ t2_im) {
  const int tc = p.tc, ld = tc + 1;
  const int c = u & (tc - 1), t = u >> p.log_tc;
  const int k = t & (h - 1);
  const int i = (((t >> q) << (q + 1)) | k) * ld + c;
  const int j = i + h * ld;
  // the 2-D table's twiddle of this stage, row 2^q + k, this column
  int32_t tr = 0, ti = 0;
  if (kTwoD && c0 + c < p.cols) {
    const size_t g = static_cast<size_t>(h + k) * p.cols + c0 + c;
    tr = __ldg(t2_re + g);
    ti = __ldg(t2_im + g);
  }
  V sr, si, dr, di;
  if (kInverse) {
    // B times conj(W) first, wrapped to in_w; W = -j on the odd index
    // of order 1 makes it B * j = (neg_guarded(bi), br)
    const V br = s_re[j], bi = s_im[j];
    V bwr = br, bwi = bi;
    if (kTwoD) {
      cmult(br, bi, tr, -ti, p.tw_shift, in_w, bwr, bwi);
    } else if (q == 1) {
      if (k & 1) {
        bwr = neg_guarded(bi);
        bwi = br;
      }
    } else if (q > 1) {
      cmult(br, bi, __ldg(w_re + h + k), -__ldg(w_im + h + k),
            p.tw_shift, in_w, bwr, bwi);
    }
    bfly(s_re[i], bwr, in_w, p.scale, p.round, sr, dr);
    bfly(s_im[i], bwi, in_w, p.scale, p.round, si, di);
  } else {
    V yr, yi;
    bfly(s_re[i], s_re[j], in_w, p.scale, p.round, sr, yr);
    bfly(s_im[i], s_im[j], in_w, p.scale, p.round, si, yi);
    dr = yr;
    di = yi;
    if (kTwoD) {
      cmult(yr, yi, tr, ti, p.tw_shift, out_w, dr, di);
    } else if (q == 1) {
      // W = -j on the odd index: (re, im) = (im, neg_guarded(re))
      if (k & 1) {
        dr = yi;
        di = neg_guarded(yr);
      }
    } else if (q > 1) {
      cmult(yr, yi, __ldg(w_re + h + k), __ldg(w_im + h + k),
            p.tw_shift, out_w, dr, di);
    }
  }
  s_re[i] = sr;
  s_im[i] = si;
  s_re[j] = dr;
  s_im[j] = di;
}

// ---------------------------------------------------------- stage groups

// Stages a group holds at most, by tile type.  Three on the int64 tile too:
// its kernels then take all 128 registers a thread of two CTAs per SM (the
// inverse spills 16 bytes), and still ran the [4096, 1024] int64 transform
// 2 % faster on an H100 than with groups of two (the probe's group64_3_*
// against group64_2_* steps read the same way).
template <typename V>
struct GroupSize {
  static constexpr int R = 3;
};
template <>
struct GroupSize<int64_t> {
  static constexpr int R = 3;
};

// The groups of a factor of 2^log_rows rows at group size R: R orders each
// from the top order down, the remainder at the bottom.  group_of: the top
// order q and the size r of group g (0 = the top group).  The forward runs
// the groups 0, 1, ..., the inverse the other way.
__host__ __device__ inline int group_count(int log_rows, int R) {
  return (log_rows + R - 1) / R;
}
__host__ __device__ inline void group_of(int log_rows, int R, int g, int& q,
                                         int& r) {
  if (g < log_rows / R) {
    q = log_rows - 1 - g * R;
    r = R;
  } else {
    r = log_rows % R;
    q = r - 1;
  }
}

// Task u of a group of R orders from lo up: its tile column c, the low row
// bits k0 (below bit lo: they are the low bits of every twiddle index of the
// group) and its first row; the others are base + (a << lo).
template <int R>
__device__ __forceinline__ void group_rows(int u, int lo, const PassParams& p,
                                           int& c, int& k0, int& base) {
  c = u & (p.tc - 1);
  const int t = u >> p.log_tc;
  k0 = t & ((1 << lo) - 1);
  base = ((t >> lo) << (lo + R)) | k0;
}

template <typename V, int R>
__device__ __forceinline__ void group_load_tile(const V* s_re, const V* s_im,
                                                int first, int step,
                                                V (&xr)[1 << R],
                                                V (&xi)[1 << R]) {
#pragma unroll
  for (int a = 0; a < (1 << R); ++a) {
    xr[a] = s_re[first + a * step];
    xi[a] = s_im[first + a * step];
  }
}

template <typename V, int R>
__device__ __forceinline__ void group_store_tile(V* s_re, V* s_im, int first,
                                                 int step,
                                                 const V (&xr)[1 << R],
                                                 const V (&xi)[1 << R]) {
#pragma unroll
  for (int a = 0; a < (1 << R); ++a) {
    s_re[first + a * step] = xr[a];
    s_im[first + a * step] = xi[a];
  }
}

// The butterfly of a group.  On the int32 tile the mode is data, not
// branches (bfly_flat): with up to twelve butterflies inlined in one body
// the compiler can then interleave the independent ones, which is worth
// 10 to 14 % where an SM holds one CTA of eight warps (m >= 1024).  The
// int64 tile keeps the branches: its paths are mostly unscaled, where the
// flat form issues shifts and masks that the unscaled arm does not have
// (the 24-bit widening path read 10 % slower with it).
template <typename V>
__device__ __forceinline__ void group_bfly(V a, V b, int in_w,
                                           const PassParams& p, V& s, V& d) {
  if constexpr (sizeof(V) == 4) {
    bfly_flat(a, b, in_w + 1 - p.scale, p.scale,
              static_cast<V>(p.scale & p.round), s, d);
  } else {
    bfly(a, b, in_w, p.scale, p.round, s, d);
  }
}

// The stage of order lo + BIT on a task's registers: it pairs the values
// whose index differs in bit BIT, and reads 2^BIT distinct twiddles,
// w[2^q + ((kk << lo) | k0)].  kLo says what the group's lowest order is
// known to be at compile time: 0 or 1 (then lo == kLo, and the stages of
// order 0 and 1 take their own forms: no product, and -j on the odd index,
// +j inverse), or 2 for "at least 2" (every stage multiplies; lo is read at
// run time).  in_w is the width entering the stage.  The arithmetic is
// stage_body's, butterfly for butterfly.
template <typename V, bool kInverse, bool kTwoD, int R, int kLo, int BIT>
__device__ __forceinline__ void group_stage(
    V (&xr)[1 << R], V (&xi)[1 << R], int lo, int k0, int in_w,
    const PassParams& p, int col, const int32_t* __restrict__ w_re,
    const int32_t* __restrict__ w_im, const int32_t* __restrict__ t2_re,
    const int32_t* __restrict__ t2_im) {
  constexpr int H = 1 << BIT;
  constexpr bool kMul = kTwoD || kLo + BIT >= 2;
  constexpr bool kTurn = !kTwoD && kLo + BIT == 1;   // the order-1 stage
  const int q = lo + BIT;
  const int out_w = in_w + 1 - p.scale;
  int32_t tr[H], ti[H];
  if constexpr (kMul) {
#pragma unroll
    for (int kk = 0; kk < H; ++kk) {
      const int k = (1 << q) + ((kk << lo) | k0);
      if constexpr (kTwoD) {
        // row 2^q + k of the 2-D table, this column
        tr[kk] = ti[kk] = 0;
        if (col < p.cols) {
          const size_t g = static_cast<size_t>(k) * p.cols + col;
          tr[kk] = __ldg(t2_re + g);
          ti[kk] = __ldg(t2_im + g);
        }
      } else {
        tr[kk] = __ldg(w_re + k);
        ti[kk] = __ldg(w_im + k);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < (1 << R); ++a) {
    if (a & H) continue;
    const int b = a | H, kk = a & (H - 1);
    const bool odd = (((kk << lo) | k0) & 1) != 0;
    V sr, si, dr, di;
    if constexpr (kInverse) {
      // B times conj(W) first, wrapped to in_w; W = -j on the odd index of
      // order 1 makes it B * j = (neg_guarded(bi), br)
      V bwr = xr[b], bwi = xi[b];
      if constexpr (kMul) {
        cmult(xr[b], xi[b], tr[kk], -ti[kk], p.tw_shift, in_w, bwr, bwi);
      } else if constexpr (kTurn) {
        if (odd) {
          bwr = neg_guarded(xi[b]);
          bwi = xr[b];
        }
      }
      group_bfly(xr[a], bwr, in_w, p, sr, dr);
      group_bfly(xi[a], bwi, in_w, p, si, di);
    } else {
      V yr, yi;
      group_bfly(xr[a], xr[b], in_w, p, sr, yr);
      group_bfly(xi[a], xi[b], in_w, p, si, yi);
      dr = yr;
      di = yi;
      if constexpr (kMul) {
        cmult(yr, yi, tr[kk], ti[kk], p.tw_shift, out_w, dr, di);
      } else if constexpr (kTurn) {
        // W = -j on the odd index: (re, im) = (im, neg_guarded(re))
        if (odd) {
          dr = yi;
          di = neg_guarded(yr);
        }
      }
    }
    xr[a] = sr;
    xi[a] = si;
    xr[b] = dr;
    xi[b] = di;
  }
}

// R consecutive stages (orders lo .. lo + R - 1) on one task's 2^R values
// xr/xi[a] = row base + (a << lo): forward from the top order down, inverse
// from the bottom up.  in_w0 is the width entering the group's first stage;
// every stage adds 1 - scale to it.  col is the task's global column (the
// 2-D tables' index).  J counts the stages done.
template <typename V, bool kInverse, bool kTwoD, int R, int kLo, int J = 0>
__device__ __forceinline__ void stage_group(
    V (&xr)[1 << R], V (&xi)[1 << R], int lo, int k0, int in_w0,
    const PassParams& p, int col, const int32_t* __restrict__ w_re,
    const int32_t* __restrict__ w_im, const int32_t* __restrict__ t2_re,
    const int32_t* __restrict__ t2_im) {
  if constexpr (J < R) {
    group_stage<V, kInverse, kTwoD, R, kLo, kInverse ? J : R - 1 - J>(
        xr, xi, kLo < 2 ? kLo : lo, k0, in_w0 + J * (1 - p.scale), p, col,
        w_re, w_im, t2_re, t2_im);
    stage_group<V, kInverse, kTwoD, R, kLo, J + 1>(
        xr, xi, lo, k0, in_w0, p, col, w_re, w_im, t2_re, t2_im);
  }
}

// Task u of a group on the tile, from shared memory and back to it: what a
// group between two others does in the pass, and what the probe's group
// steps apply.  c0: the tile's first global column.
template <typename V, bool kInverse, bool kTwoD, int R, int kLo>
__device__ __forceinline__ void group_on_tile(
    V* s_re, V* s_im, int u, int lo, int in_w0, const PassParams& p, int c0,
    const int32_t* __restrict__ w_re, const int32_t* __restrict__ w_im,
    const int32_t* __restrict__ t2_re, const int32_t* __restrict__ t2_im) {
  const int ld = p.tc + 1;
  int c, k0, base;
  group_rows<R>(u, lo, p, c, k0, base);
  V xr[1 << R], xi[1 << R];
  group_load_tile<V, R>(s_re, s_im, base * ld + c, ld << lo, xr, xi);
  stage_group<V, kInverse, kTwoD, R, kLo>(xr, xi, lo, k0, in_w0, p, c0 + c,
                                          w_re, w_im, t2_re, t2_im);
  group_store_tile<V, R>(s_re, s_im, base * ld + c, ld << lo, xr, xi);
}

}  // namespace
