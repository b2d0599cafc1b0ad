"""The port's integer primitives (intfftk_tpu_torch.ops.intmath) against the
JAX ones (intfftk_tpu.ops.intmath) and the golden model, exactly, on the
int32 edge set plus random values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intfftk_tpu.golden import int_model as golden
from intfftk_tpu.golden.twiddle import stage_twiddles_int
from intfftk_tpu.ops import intmath as jm
from intfftk_tpu_torch.ops import intmath as tm

EDGE = np.array([-2**31, -2**31 + 1, -3, -2, -1, 0, 1, 2, 3,
                 2**31 - 2, 2**31 - 1], np.int64)


def _int32(seed, n=4096):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(-2**31, 2**31, n)]).astype(
        np.int32)


def _jax(f, *args):
    return np.asarray(f(*[jnp.asarray(a) for a in args])).astype(np.int64)


def _torch(f, *args):
    return f(*[torch.as_tensor(a) for a in args]).numpy().astype(np.int64)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_neg_guarded(dtype):
    v = _int32(0).astype(dtype)
    got = _torch(tm.neg_guarded, v)
    np.testing.assert_array_equal(got, golden.neg_guarded(v.astype(np.int64)))
    if dtype == np.int32:
        np.testing.assert_array_equal(got, _jax(jm.neg_guarded, v))


@pytest.mark.parametrize("w", [8, 15, 16, 17, 24, 31, 32])
def test_wrap_width(w):
    v = _int32(1)
    got = _torch(lambda x: tm.wrap_width(x, w), v)
    np.testing.assert_array_equal(got, _jax(lambda x: jm.wrap_width(x, w), v))
    np.testing.assert_array_equal(
        got, golden.wrap_width(v.astype(np.int64), w))
    # int64 tensors wrap at the same width
    np.testing.assert_array_equal(
        _torch(lambda x: tm.wrap_width(x, w), v.astype(np.int64)), got)


@pytest.mark.parametrize("s,w", [(15, 16), (15, 17), (17, 15), (0, 16),
                                 (1, 32), (23, 24), (25, 7)])
def test_shift_wrap(s, w):
    v = _int32(2)
    np.testing.assert_array_equal(
        _torch(lambda x: tm.shift_wrap(x, s, w), v),
        _jax(lambda x: jm.shift_wrap(x, s, w), v))


@pytest.mark.parametrize("name", ["round_half_up", "add_round_half_up",
                                  "sub_round_half_up"])
def test_round_forms(name):
    a, b = _int32(3), _int32(4)
    a64, b64 = a.astype(np.int64), b.astype(np.int64)
    pf, jf = getattr(tm, name), getattr(jm, name)
    if name == "round_half_up":
        got, want = _torch(pf, a), golden.round_half_up(a64)
        np.testing.assert_array_equal(got, _jax(jf, a))
    else:
        got = _torch(pf, a, b)
        exact = a64 + b64 if name.startswith("add") else a64 - b64
        # int32 registers: the one value past 2^31 - 1 wraps
        want = golden.wrap_width(golden.round_half_up(exact), 32)
        np.testing.assert_array_equal(got, _jax(jf, a, b))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conj", [False, True], ids=["w", "conj"])
@pytest.mark.parametrize("tw", [16, 18, 25])
@pytest.mark.parametrize("dw", [16, 24, 32])
def test_cmult_exact(dw, tw, conj):
    """One int64 product-sum, floor shift and wrap == the JAX limb tiers
    == golden cmult_int; ``conj`` (the inverse) negates the twiddle's
    imaginary part."""
    rng = np.random.default_rng(dw * 100 + tw)
    lim = 1 << (dw - 1)
    edge = np.array([-lim, -lim + 1, -1, 0, 1, lim - 1], np.int64)
    br = np.concatenate([np.repeat(edge, edge.size),
                         rng.integers(-lim, lim, 4096)])
    bi = np.concatenate([np.tile(edge, edge.size),
                         rng.integers(-lim, lim, 4096)])
    w_re, w_im = stage_twiddles_int(9, tw)
    idx = rng.integers(0, w_re.size, br.size)
    idx[:4] = [0, 128, 256, 384]            # axis twiddles (1, -j, ...)
    c, d = w_re[idx], w_im[idx]
    shift = tw - 1 if tw < 19 else tw - 2
    got = tm.cmult_exact(*(torch.as_tensor(x.astype(np.int32))
                           for x in (br, bi, c, d)), shift, dw, conj=conj)
    got = [g.numpy() for g in got]
    want = golden.cmult_int(br, bi, c, -d if conj else d, shift, dw)
    plan = jm.CmultPlan(data_width=dw, twiddle_width=tw, shift=shift,
                        out_width=dw)
    jax_out = jm.cmult_exact(plan, *(jnp.asarray(x.astype(np.int32))
                                     for x in (br, bi, c, d)), conj=conj)
    for g, w, j in zip(got, want, jax_out):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.asarray(j).astype(np.int64))


PRODUCT_CASES = {
    # data bits, data dtype, spectrum bits, shift, out bits
    "32+25": (32, torch.int32, 25, 14, 44),
    "48+25": (48, torch.int64, 25, 23, 48),
    "63+27": (63, torch.int64, 27, 26, 63),
    "32+16_narrow": (32, torch.int32, 16, 15, 32),
    "30+25_int64_narrow": (30, torch.int64, 25, 24, 30),
}


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.int64, None],
                         ids=["int32", "int64", "default"])
@pytest.mark.parametrize("case", list(PRODUCT_CASES))
def test_spectrum_product(case, out_dtype):
    """The product on CPU tensors (its plain version) == cmult_exact ==
    Python-int arithmetic, at full scale, for every output dtype that holds
    the result; the table is broadcast over the leading axes."""
    dw, dt, sw, shift, ow = PRODUCT_CASES[case]
    if out_dtype == torch.int32 and ow > 32:
        with pytest.raises(ValueError, match="holds no"):
            tm.spectrum_product(torch.zeros(2, 4, dtype=dt),
                                torch.zeros(2, 4, dtype=dt),
                                torch.zeros(4, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int32), shift, ow,
                                sw, out_dtype)
        return
    rng = np.random.default_rng(dw + sw)
    lim, hlim = 1 << (dw - 1), 1 << (sw - 1)
    block = (3, 5)
    fr, fi = (rng.integers(-lim, lim, (2, 4) + block) for _ in range(2))
    hr, hi = (rng.integers(-hlim, hlim, block) for _ in range(2))
    fr[0, 0, 0, :2], fi[0, 0, 0, :2] = (-lim, lim - 1), (lim - 1, -lim)
    hr[0, :2], hi[0, :2] = (-hlim, hlim - 1), (-hlim, -hlim)
    t = lambda a, d: torch.as_tensor(a).to(d)
    args = (t(fr, dt), t(fi, dt), t(hr, torch.int32), t(hi, torch.int32))
    before = tm.spectrum_product.launches
    yr, yi = tm.spectrum_product(*args, shift, ow, sw, out_dtype)
    assert tm.spectrum_product.launches == before   # the CPU launches none
    want_dt = out_dtype or (torch.int32 if ow <= 32 else torch.int64)
    assert yr.dtype == yi.dtype == want_dt and yr.shape == args[0].shape
    cr, ci = tm.cmult_exact(*args, shift, ow, twiddle_width=sw)
    assert torch.equal(yr.long(), cr) and torch.equal(yi.long(), ci)
    pr, pi = tm.spectrum_product_reference(*args, shift, ow, sw, out_dtype)
    assert torch.equal(yr, pr) and torch.equal(yi, pi)

    def wrap(v):
        v &= (1 << ow) - 1
        return v - (1 << ow) if v >> (ow - 1) else v

    c, d = np.broadcast_to(hr, fr.shape), np.broadcast_to(hi, fr.shape)
    for a, b, cc, dd, gr, gi in zip(*(v.reshape(-1).tolist() for v in (
            fr, fi, c, d, yr.numpy(), yi.numpy()))):
        assert gr == wrap((a * cc - b * dd) >> shift)
        assert gi == wrap((b * cc + a * dd) >> shift)


def test_spectrum_product_checks():
    z = lambda *s, d=torch.int32: torch.zeros(*s, dtype=d)
    with pytest.raises(TypeError, match="int32 or int64"):
        tm.spectrum_product(z(2, 4, d=torch.int16), z(2, 4, d=torch.int16),
                            z(4), z(4), 1, 16)
    with pytest.raises(ValueError, match="int32 table"):
        tm.spectrum_product(z(2, 4), z(2, 4), z(4, d=torch.int64),
                            z(4, d=torch.int64), 1, 16)
    with pytest.raises(ValueError, match=r"\[B, \*block\]"):
        tm.spectrum_product(z(2, 4), z(2, 4), z(3), z(3), 1, 16)
    with pytest.raises(ValueError, match="spectrum width"):
        tm.spectrum_product(z(2, 4), z(2, 4), z(4), z(4), 1, 16, 28)
    # the host's rule for the product-sum's type (cmult_exact's)
    assert not tm._wide_product(z(1), 44, 25)           # 32 + 25 + 1
    assert tm._wide_product(z(1, d=torch.int64), 48, 25)
    assert not tm._wide_product(z(1, d=torch.int64), 30, 25)


# ------------------------------------- the int64 tile's product modulo 2^64

WORD = 1 << 64


def _wrap_exact(v, w):
    """wrap_width of a Python int at w bits."""
    v &= (1 << w) - 1
    return v - (1 << w) if v >> (w - 1) else v


def _as_int64(u):
    return u - WORD if u >> 63 else u


def _cmult_mod64(br, bi, c, d, s, w):
    """cmult's modular form on the int64 tile as the kernel computes it
    (csrc/intfft_arith.cuh, P = uint64): each product a low 64-bit multiply
    of the datum by the sign-extended int32 twiddle, the sums modulo 2^64,
    then the shift left by 64 - w - s and the arithmetic shift right by
    64 - w of the word."""
    u = lambda v: v % WORD
    pr = (u(br) * u(c) - u(bi) * u(d)) % WORD
    pi = (u(bi) * u(c) + u(br) * u(d)) % WORD
    fold = lambda p: _as_int64((p << (64 - w - s)) % WORD) >> (64 - w)
    return fold(pr), fold(pi)


def _cmult_word_shift_wrap(br, bi, c, d, s, w):
    """The same product-sums modulo 2^64, shifted right by s and wrapped to
    w bits, as cmult's generic arm computes them on the word (defined at any
    s + w, where the fold's left shift would be negative)."""
    u = lambda v: v % WORD
    pr = (u(br) * u(c) - u(bi) * u(d)) % WORD
    pi = (u(bi) * u(c) + u(br) * u(d)) % WORD
    return _wrap_exact(pr >> s, w), _wrap_exact(pi >> s, w)


def _cmult_exact_int(br, bi, c, d, s, w):
    """wrap(floor((a c -+ b d) / 2^s), w) in exact integers."""
    return (_wrap_exact((br * c - bi * d) >> s, w),
            _wrap_exact((bi * c + br * d) >> s, w))


def _mod64_cases(w, t, seed, n=3000):
    """(br, bi, c, d): the data at their w-bit and 64-bit extremes against
    twiddles of t bits at +-(2^(t-1) - 1) and -2^(t-1), then random data
    of w bits, of 64 bits and random twiddles of t bits."""
    data = [-(1 << (w - 1)), (1 << (w - 1)) - 1, -(1 << 63), (1 << 63) - 1,
            -1, 0, 1]
    tw = [(1 << (t - 1)) - 1, -((1 << (t - 1)) - 1), -(1 << (t - 1)), 0, 1,
          -1]
    out = [(a, b, c, d) for a in data for b in data for c in tw for d in tw]
    rng = np.random.default_rng(seed)
    for lim in (1 << (w - 1), 1 << 63):
        a = rng.integers(-lim, lim, (n, 2), dtype=np.int64).tolist()
        c = rng.integers(-(1 << (t - 1)), 1 << (t - 1), (n, 2)).tolist()
        out += [(x, y, p, q) for (x, y), (p, q) in zip(a, c)]
    return out


@pytest.mark.parametrize("conj", [False, True], ids=["fwd", "inv_conj"])
@pytest.mark.parametrize("w,s,t", [(44, 15, 16), (49, 15, 16), (33, 15, 16),
                                   (46, 18, 20), (38, 26, 27)],
                         ids=["config4", "bound_49", "w33", "config2_64",
                              "t27"])
def test_cmult_mod64_equals_exact(w, s, t, conj):
    """Where s + w <= 64 the product-sums formed modulo 2^64 and folded
    into two shifts of the word give wrap(floor(p / 2^s), w) of the exact
    product-sums, for every datum of 64 bits and every twiddle of t bits,
    the most negative included; the inverse multiplies by the conjugate
    (d negated, -2^(t-1) becoming +2^(t-1))."""
    assert s + w <= 64
    for br, bi, c, d in _mod64_cases(w, t, seed=w * 100 + s):
        if conj:
            d = -d
        want = _cmult_exact_int(br, bi, c, d, s, w)
        assert _cmult_mod64(br, bi, c, d, s, w) == want, (br, bi, c, d)
        assert _cmult_word_shift_wrap(br, bi, c, d, s, w) == want


def test_cmult_mod64_wrong_past_the_word():
    """At s + w = 65 the kept bits reach bit 64 of the product-sum, which
    the word does not hold: the modular form differs from the exact one
    (here at (w, s) = (50, 15), on full-scale data against full-scale
    twiddles), so the bound is the rule's edge and not a margin."""
    w, s = 50, 15
    cases = _mod64_cases(w, 16, seed=65)
    wrong = sum(_cmult_word_shift_wrap(*v, s, w) != _cmult_exact_int(
        *v, s, w) for v in cases)
    assert wrong > len(cases) // 10
    # one case by hand: -2^49 * (2^15 - 1) is negative, so bit 64, the
    # top one of the 50 kept, is set; modulo 2^64 it reads 0
    a, c = -(1 << 49), (1 << 15) - 1
    assert _cmult_exact_int(a, 0, c, 0, s, w)[0] < 0
    assert _cmult_word_shift_wrap(a, 0, c, 0, s, w)[0] >= 0


WORD32 = 1 << 32


def _cmult_mod32_folded(br, bi, c, d, s, w):
    """cmult's modular form on the int32 tile as the kernel computes it
    (csrc/intfft_arith.cuh, fold and cmult_folded): each twiddle component
    times 2^(32 - w - s) modulo 2^32 where the stage reads it, the
    product-sums of the int32 datum and the folded twiddle modulo 2^32,
    then the arithmetic shift right by 32 - w of the word."""
    u = lambda v: v % WORD32
    f = 1 << (32 - w - s)
    fc, fd = u(c) * f % WORD32, u(d) * f % WORD32
    pr = (u(br) * fc - u(bi) * fd) % WORD32
    pi = (u(bi) * fc + u(br) * fd) % WORD32
    signed = lambda p: p - WORD32 if p >> 31 else p
    return signed(pr) >> (32 - w), signed(pi) >> (32 - w)


def _mod32_cases(w, t, seed, n=3000):
    """(br, bi, c, d): int32 data at their w-bit and 32-bit extremes
    against twiddles of t bits at +-(2^(t-1) - 1) and -2^(t-1), then
    random data of w bits and of 32 bits against random twiddles."""
    data = [-(1 << (w - 1)), (1 << (w - 1)) - 1, -(1 << 31), (1 << 31) - 1,
            -1, 0, 1]
    tw = [(1 << (t - 1)) - 1, -((1 << (t - 1)) - 1), -(1 << (t - 1)), 0, 1,
          -1]
    out = [(a, b, c, d) for a in data for b in data for c in tw for d in tw]
    rng = np.random.default_rng(seed)
    for lim in (1 << (w - 1), 1 << 31):
        a = rng.integers(-lim, lim, (n, 2)).tolist()
        c = rng.integers(-(1 << (t - 1)), 1 << (t - 1), (n, 2)).tolist()
        out += [(x, y, p, q) for (x, y), (p, q) in zip(a, c)]
    return out


@pytest.mark.parametrize("conj", [False, True], ids=["fwd", "inv_conj"])
@pytest.mark.parametrize("w,s,t", [(16, 15, 16), (17, 15, 16), (9, 15, 16),
                                   (14, 18, 20), (5, 26, 27)],
                         ids=["core", "bound_17", "w9", "t20_bound",
                              "t27"])
def test_cmult_mod32_equals_exact(w, s, t, conj):
    """Where s + w <= 32 the product-sums of the int32 datum and the
    twiddle folded by 2^(32 - w - s), formed modulo 2^32 and shifted right
    by 32 - w, give wrap(floor(p / 2^s), w) of the exact product-sums, for
    every datum of 32 bits and every twiddle of t bits, the most negative
    included; the inverse negates d before the fold (-2^(t-1) becoming
    +2^(t-1)); at s + w = 32 the fold is 1."""
    assert s + w <= 32
    for br, bi, c, d in _mod32_cases(w, t, seed=w * 100 + s):
        if conj:
            d = -d
        want = _cmult_exact_int(br, bi, c, d, s, w)
        assert _cmult_mod32_folded(br, bi, c, d, s, w) == want, (br, bi, c,
                                                                 d)


def test_cmult_mod32_wrong_past_the_word():
    """At s + w = 33 the kept bits reach bit 32 of the product-sum, which
    the word does not hold: the fold by 2^-1 does not exist, and the sums
    modulo 2^32 shifted and wrapped as the word's generic arm reads them
    differ from the exact ones (at (w, s) = (18, 15), full-scale data
    against full-scale twiddles)."""
    w, s = 18, 15
    cases = _mod32_cases(w, 16, seed=33)
    word = lambda p: _wrap_exact((p % WORD32) >> s, w)
    wrong = sum((word(br * c - bi * d), word(bi * c + br * d))
                != _cmult_exact_int(br, bi, c, d, s, w)
                for br, bi, c, d in cases)
    assert wrong > len(cases) // 10
    a, c = -(1 << 17), (1 << 15) - 1
    assert _cmult_exact_int(a, 0, c, 0, s, w)[0] < 0
    assert word(a * c) >= 0


def _as_int32(u):
    u %= WORD32
    return u - WORD32 if u >> 31 else u


def _limb_sum(x0, c0, x1, c1, s):
    """limb_sum (csrc/intfft_arith.cuh) as the kernel computes it, word by
    word: each int64 datum's high word (signed) and low word read signed,
    four int32 x int32 products summed modulo 2^64, the low words' top
    bits times the factors added to L's high word modulo 2^32, then (H <<
    (32 - s)) + (L >> s) modulo 2^64."""
    h0, h1 = _as_int32(x0 >> 32), _as_int32(x1 >> 32)
    l0, l1 = _as_int32(x0), _as_int32(x1)
    t0, t1 = (x0 % WORD32) >> 31, (x1 % WORD32) >> 31
    big = (h0 * c0 + h1 * c1) % WORD
    low = (l0 * c0 + l1 * c1) % WORD
    low = (low + (((t0 * c0 + t1 * c1) % WORD32) << 32)) % WORD
    return ((big << (32 - s)) + (_as_int64(low) >> s)) % WORD


def _cmult_limb64(br, bi, c, d, s, w):
    """cmult's limb form (P = Limbs64): the two limb sums with the int32
    twiddle -d and d, each wrapped to w bits by the shift pair of the
    word."""
    wrap = lambda u: _as_int64((u << (64 - w)) % WORD) >> (64 - w)
    return (wrap(_limb_sum(br, c, bi, _as_int32(-d), s)),
            wrap(_limb_sum(bi, c, br, d, s)))


def _limb_cases(w, t, seed, n=1500):
    """(br, bi, c, d): int64 data at their w-bit and 64-bit extremes and at
    the low word's edges (its top bit set or clear under every high word,
    2^63 - 2^31 among them) against twiddles of t bits at +-(2^(t-1) - 1)
    and -2^(t-1), then random data of w and of 64 bits against random
    twiddles."""
    data = [-(1 << (w - 1)), (1 << (w - 1)) - 1, -(1 << 63), (1 << 63) - 1,
            (1 << 63) - (1 << 31), (1 << 63) - (1 << 31) - 1, 1 << 31,
            (1 << 31) - 1, -(1 << 31), -(1 << 31) - 1, -1, 0, 1]
    tw = [(1 << (t - 1)) - 1, -((1 << (t - 1)) - 1), -(1 << (t - 1)), 0, 1,
          -1]
    out = [(a, b, c, d) for a in data for b in data for c in tw for d in tw]
    rng = np.random.default_rng(seed)
    for lim in (1 << (w - 1), 1 << 63):
        a = rng.integers(-lim, lim, (n, 2), dtype=np.int64).tolist()
        c = rng.integers(-(1 << (t - 1)), 1 << (t - 1), (n, 2)).tolist()
        out += [(x, y, p, q) for (x, y), (p, q) in zip(a, c)]
    return out


@pytest.mark.parametrize("conj", [False, True], ids=["fwd", "inv_conj"])
@pytest.mark.parametrize("t,s", [(16, 15), (20, 18), (27, 25)])
@pytest.mark.parametrize("w", [48, 52, 63, 64])
def test_cmult_limb64_equals_exact(w, t, s, conj):
    """The int64 tile's exact form in 32-bit limbs gives wrap(floor(p /
    2^s), w) of the exact product-sums for every int64 datum and every
    twiddle of t bits, the most negative included, at every width a pass
    wraps to (config 2's inverse at 48 bits with 20-bit twiddles, the
    widest data's 52, up to the 64 of an unscaled 4096-row epilogue) and
    every shift the twiddles give; the inverse multiplies by the conjugate
    (d negated, -2^(t-1) becoming +2^(t-1))."""
    for br, bi, c, d in _limb_cases(w, t, seed=w * 100 + s):
        if conj:
            d = -d
        want = _cmult_exact_int(br, bi, c, d, s, w)
        assert _cmult_limb64(br, bi, c, d, s, w) == want, (br, bi, c, d)
