// stage_body.cuh -- one butterfly of one radix-2 stage on the shared-memory
// tile of the factor pass: the stage body of fused_pass_kernel
// (fused_pass.cu), as one function, so that the per-stage probe
// (probe_stages.cu) times and counts the code the pass runs and not a copy
// of it.
//
// The tile is [rows, tc] per plane, rows padded to ld = tc + 1 words; stage
// order q pairs rows i and i + 2^q.  Butterfly u of the tile takes column
// c = u mod tc and pair index t = u / tc: k = t mod 2^q is the twiddle
// index, rows i = (t / 2^q) * 2^(q+1) + k and j = i + 2^q.

#pragma once

#include "intfft_arith.cuh"

namespace {

constexpr int kThreads = 256;

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

}  // namespace
