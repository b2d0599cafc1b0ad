// intfft_arith.cuh -- the exact integer arithmetic of the butterflies, shared
// by every CUDA source of the port (fused_pass.cu, product.cu,
// probe_stages.cu): one copy of the register wrap, the guarded negate, the
// complex product and the butterfly.
//
// Numerics: every sum is formed in the tile's unsigned type (uint32, or
// uint64 on the int64 tile: modular, no signed overflow) and wrapped to the
// stage's output width with a shift pair, so the result equals the golden
// model's arithmetic followed by its wrap.  A complex product's sums are
// floor-shifted by sh and wrapped to w bits, so only their bits sh .. sh +
// w - 1 are kept.  They are formed exactly (64-bit on the int32 tile; on the
// int64 tile a 52-bit datum times a 27-bit twiddle, summed, is 80 bits:
// __int128, or in the factor pass two 32-bit limbs a datum, Limbs64, the
// same bits in 64-bit words), or, where every product of a pass keeps bits
// that fit the tile's word (sh + w <= 32, or 64), modulo 2^32 in uint32 or
// modulo 2^64 in uint64: the same bits (ProductOf; the factor pass takes
// the form per pass).  On the int32 tile the modular form folds its left
// shift into the twiddle (fold_factor, cmult_folded).
//
// Everything here has internal linkage (an unnamed namespace): each source
// that includes it compiles its own copy into its own kernels.

#pragma once

#include <cstdint>
#include <type_traits>

namespace {

// The int64 tile's exact complex product in two 32-bit limbs a datum
// (cmult's arm for P = Limbs64, limb_sum): the bits of the __int128 form,
// every product an int32 x int32 -> int64 multiply.  It takes a floor shift
// of at most kLimbMaxShift, so that 2^sh divides 2^32; twiddles are at most
// 27 bits (shift 25), and intfft_prepare_pass refuses a larger shift.
struct Limbs64 {};
constexpr int kLimbMaxShift = 32;

// The arithmetic types of a tile type V: its unsigned twin U, in which
// sums wrap; the product type P, which holds a complex product-sum of a V
// datum and an int32 twiddle exactly; and E, the factor pass's exact form
// (P itself, or on the int64 tile the limbs).
template <typename V>
struct Arith;
template <>
struct Arith<int32_t> {
  using U = uint32_t;
  using P = long long;           // |data| < 2^31, |twiddle| < 2^26
  using E = P;
};
template <>
struct Arith<int64_t> {
  using U = uint64_t;
  using P = __int128;            // |data| < 2^63, |twiddle| < 2^26
  using E = Limbs64;
};

// The form a pass forms its complex product-sums in: exact (Arith<V>::E),
// or with kMod the tile's unsigned word U, modulo 2^32 or 2^64, where every
// product of the pass keeps bits that fit the word.
template <typename V, bool kMod>
using ProductOf =
    std::conditional_t<kMod, typename Arith<V>::U, typename Arith<V>::E>;

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

// The low and high words of x, from an opaque move: read as x >> 32, the
// high word's int32 x int32 product is folded back into a 64 x 64-bit
// multiply (IMAD.WIDE.U32 and the sign words' IMADs).
__device__ __forceinline__ void words(int64_t x, int32_t& lo, int32_t& hi) {
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "l"(x));
}

// floor((x0 c0 + x1 c1) / 2^sh) modulo 2^64, exactly, for any int64 data
// x0, x1, factors |c0|, |c1| <= 2^26 and 0 <= sh <= kLimbMaxShift (the
// caller's to hold), in 64-bit words.  A datum is x = h 2^32 + l, h its high
// word (signed) and l its low word, which read signed is l - 2^32 t, t its
// top bit.  So the sum is H 2^32 + L with H = h0 c0 + h1 c1 and L = l0 c0 +
// l1 c1 + 2^32 (t0 c0 + t1 c1), the low words signed: four int32 x int32
// -> int64 products (IMAD.WIDE), |H| <= 2^58 and |L| < 2^59, the carries
// t c added to L's high word modulo 2^32 (two IMADs).  2^sh divides 2^32,
// so the floor shift is exact on the two parts: H 2^(32 - sh) + (L >> sh).
// (The balanced split, l in [-2^31, 2^31) and h = hi + t, saves the carries
// but its h does not fit 32 bits from x = 2^63 - 2^31 up.)
__device__ __forceinline__ uint64_t limb_sum(int64_t x0, int32_t c0,
                                             int64_t x1, int32_t c1, int sh) {
  int32_t l0, h0, l1, h1;
  words(x0, l0, h0);
  words(x1, l1, h1);
  const uint32_t t0 = static_cast<uint32_t>(l0) >> 31;
  const uint32_t t1 = static_cast<uint32_t>(l1) >> 31;
  const int64_t H = static_cast<int64_t>(h0) * c0 +
                    static_cast<int64_t>(h1) * c1;
  int64_t L = static_cast<int64_t>(l0) * c0 + static_cast<int64_t>(l1) * c1;
  asm("{\n\t"
      ".reg .u32 lo, hi;\n\t"
      "mov.b64 {lo, hi}, %0;\n\t"
      "mad.lo.u32 hi, %1, %2, hi;\n\t"
      "mad.lo.u32 hi, %3, %4, hi;\n\t"
      "mov.b64 %0, {lo, hi};\n\t"
      "}"
      : "+l"(L)
      : "r"(t0), "r"(c0), "r"(t1), "r"(c1));
  return (static_cast<uint64_t>(H) << (32 - sh)) +
         static_cast<uint64_t>(L >> sh);
}

// (br + j*bi) * (c + j*d) >> sh, wrapped to w bits.  P is the form the
// product-sums are formed in: the tile's exact product type unless the
// caller knows a narrower one holds them (the spectrum product: a 32-bit
// datum on the int64 register); on the int64 tile the limbs (Limbs64,
// limb_sum), exact in 64-bit words; or the tile's unsigned word U, in which
// they are formed modulo its 2^bits.  The wrap reads bits sh .. sh + w - 1
// of each product-sum, which the word holds exactly where sh + w <= bits:
// the caller's to hold (intfft_prepare_pass refuses a pass that breaks
// it); the floor shift and the wrap are then one pair of shifts.  Every
// value of the data and the twiddles gives the bits of the exact form,
// the most negative ones included.
template <typename V, typename P = typename Arith<V>::P>
__device__ __forceinline__ void cmult(V br, V bi, int32_t c, int32_t d,
                                      int sh, int w, V& yr, V& yi) {
  using U = typename Arith<V>::U;
  if constexpr (std::is_same_v<P, Limbs64>) {
    static_assert(sizeof(V) == 8, "the limbs are the int64 tile's form");
    yr = wrap<V>(limb_sum(br, c, bi, -d, sh), w);
    yi = wrap<V>(limb_sum(bi, c, br, d, sh), w);
  } else {
    const P pr = static_cast<P>(br) * c - static_cast<P>(bi) * d;
    const P pi = static_cast<P>(bi) * c + static_cast<P>(br) * d;
    if constexpr (std::is_same_v<P, U>) {
      constexpr int bits = 8 * static_cast<int>(sizeof(V));
      yr = static_cast<V>(pr << (bits - w - sh)) >> (bits - w);
      yi = static_cast<V>(pi << (bits - w - sh)) >> (bits - w);
    } else {
      yr = wrap<V>(static_cast<U>(pr >> sh), w);
      yi = wrap<V>(static_cast<U>(pi >> sh), w);
    }
  }
}

// Whether products of form P on the V tile fold their left shift into the
// twiddle: the int32 tile's modular form.  Its product-sums keep bits sh ..
// sh + w - 1 of 32, which the modular arm of cmult moves to the top with a
// left shift by k = 32 - w - sh and brings down with an arithmetic right
// shift by 32 - w: two shifts a sum on the ALU pipe.  Modulo 2^32, br * (c
// * 2^k) is (br * c) * 2^k, so the caller multiplies each twiddle by
// fold_factor once where it reads it (an IMAD, on the FMA pipe, shared by
// the butterflies of a stage) and each sum keeps one shift (cmult_folded).
template <typename V, typename P>
constexpr bool kFolds =
    sizeof(V) == 4 && std::is_same_v<P, typename Arith<V>::U>;

// 2^(32 - w - sh), the factor of a folded twiddle; sh + w <= 32 (the
// caller's to hold).  The empty asm keeps it an opaque register, so the
// compiler multiplies by it and does not turn the product into a shift.
__device__ __forceinline__ uint32_t fold_factor(int sh, int w) {
  uint32_t f = 1u << (32 - w - sh);
  asm("" : "+r"(f));
  return f;
}

// A twiddle component times the factor, modulo 2^32.
__device__ __forceinline__ int32_t fold(int32_t c, uint32_t f) {
  return static_cast<int32_t>(static_cast<uint32_t>(c) * f);
}

// cmult on the int32 tile with the twiddle (c, d) folded (fold): the
// product-sums modulo 2^32 hold bits sh .. sh + w - 1 of the exact ones at
// the top, and the arithmetic shift by 32 - w gives them wrapped to w bits.
__device__ __forceinline__ void cmult_folded(int32_t br, int32_t bi,
                                             int32_t c, int32_t d, int w,
                                             int32_t& yr, int32_t& yi) {
  const uint32_t uc = static_cast<uint32_t>(c), ud = static_cast<uint32_t>(d);
  const uint32_t pr = static_cast<uint32_t>(br) * uc -
                      static_cast<uint32_t>(bi) * ud;
  const uint32_t pi = static_cast<uint32_t>(bi) * uc +
                      static_cast<uint32_t>(br) * ud;
  yr = static_cast<int32_t>(pr) >> (32 - w);
  yi = static_cast<int32_t>(pi) >> (32 - w);
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
