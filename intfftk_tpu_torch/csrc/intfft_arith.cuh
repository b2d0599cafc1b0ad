// intfft_arith.cuh -- the exact integer arithmetic of the butterflies, shared
// by every CUDA source of the port (fused_pass.cu, product.cu,
// probe_stages.cu): one copy of the register wrap, the guarded negate, the
// complex product and the butterfly.
//
// Numerics: every sum is formed in the tile's unsigned type (uint32, or
// uint64 on the int64 tile: modular, no signed overflow) and wrapped to the
// stage's output width with a shift pair, so the result equals the golden
// model's arithmetic followed by its wrap; the complex products are exact
// product-sums (64-bit on the int32 tile, __int128 on the int64 tile: a
// 52-bit datum times a 27-bit twiddle, summed, is 80 bits), floor-shifted
// and then wrapped.
//
// Everything here has internal linkage (an unnamed namespace): each source
// that includes it compiles its own copy into its own kernels.

#pragma once

#include <cstdint>

namespace {

// The arithmetic types of a tile type V: its unsigned twin U, in which
// sums wrap, and the product type P, which holds a complex product-sum of
// a V datum and an int32 twiddle exactly.
template <typename V>
struct Arith;
template <>
struct Arith<int32_t> {
  using U = uint32_t;
  using P = long long;           // |data| < 2^31, |twiddle| < 2^26
};
template <>
struct Arith<int64_t> {
  using U = uint64_t;
  using P = __int128;            // |data| < 2^63, |twiddle| < 2^26
};

// Low w bits of v as a signed w-bit value, 1 <= w <= the bits of V.
template <typename V>
__device__ __forceinline__ V wrap(typename Arith<V>::U v, int w) {
  const int sh = 8 * static_cast<int>(sizeof(V)) - w;
  return static_cast<V>(v << sh) >> sh;
}

// -x for x >= 0, -x - 1 for x < 0 (int_dif2_fly.vhd:281-304): exact at
// the most-negative value.
template <typename V>
__device__ __forceinline__ V neg_guarded(V x) {
  using U = typename Arith<V>::U;
  return static_cast<V>(static_cast<U>(x >> (8 * sizeof(V) - 1)) -
                        static_cast<U>(x));
}

// (br + j*bi) * (c + j*d) >> sh, wrapped to w bits; each product-sum is
// exact in P before the floor shift.  P is the tile's product type unless
// the caller knows a narrower one holds its product-sum (the spectrum
// product: a 32-bit datum on the int64 register).
template <typename V, typename P = typename Arith<V>::P>
__device__ __forceinline__ void cmult(V br, V bi, int32_t c, int32_t d,
                                      int sh, int w, V& yr, V& yi) {
  using U = typename Arith<V>::U;
  const P pr = static_cast<P>(br) * c - static_cast<P>(bi) * d;
  const P pi = static_cast<P>(bi) * c + static_cast<P>(br) * d;
  yr = wrap<V>(static_cast<U>(pr >> sh), w);
  yi = wrap<V>(static_cast<U>(pi >> sh), w);
}

// Sum and difference with the mode's scale (1: per-stage /2) and rounding
// (1: round half up, 0: truncate), wrapped to out_w = in_w + 1 - scale
// bits: the DIF butterfly (int_dif2_fly.vhd:144-241) and the DIT combine
// of A with B*W (int_dit2_fly.vhd:142-217) are the same arithmetic.  The
// round-mode difference reaches +2^(w-1) at (max, min) and wraps to
// -2^(w-1).
template <typename V>
__device__ __forceinline__ void bfly(V a, V b, int in_w, int scale, int round,
                                     V& s, V& d) {
  using U = typename Arith<V>::U;
  const int out_w = in_w + 1 - scale;
  U su, du;
  if (scale && !round) {
    su = static_cast<U>(a >> 1) + static_cast<U>(b >> 1);
    du = static_cast<U>(a >> 1) - static_cast<U>(b >> 1);
  } else if (scale) {
    // round_half_up(a +- b) without the wider sum
    // (intmath.add_round_half_up / sub_round_half_up)
    su = static_cast<U>(a >> 1) + static_cast<U>(b >> 1) +
         static_cast<U>((a | b) & 1);
    du = static_cast<U>(a >> 1) - static_cast<U>(b >> 1) +
         static_cast<U>(a & ~b & 1);
  } else {
    su = static_cast<U>(a) + static_cast<U>(b);
    du = static_cast<U>(a) - static_cast<U>(b);
  }
  s = wrap<V>(su, out_w);
  d = wrap<V>(du, out_w);
}

// The same sums without a branch on the mode, for code that inlines many
// butterflies (a stage group): sh = scale, rnd = scale & round, both the
// same for every butterfly of a launch.  Unscaled (sh = 0, rnd = 0) it is
// a + b and a - b; scaled, the halves' sum and difference, plus the
// rounding bits (a | b) & 1 and a & ~b & 1 where rnd is 1: bfly's three
// arms, bit for bit.
template <typename V>
__device__ __forceinline__ void bfly_flat(V a, V b, int out_w, int sh, V rnd,
                                          V& s, V& d) {
  using U = typename Arith<V>::U;
  const U ah = static_cast<U>(a >> sh), bh = static_cast<U>(b >> sh);
  s = wrap<V>(ah + bh + static_cast<U>((a | b) & rnd), out_w);
  d = wrap<V>(ah - bh + static_cast<U>(a & ~b & rnd), out_w);
}

}  // namespace
