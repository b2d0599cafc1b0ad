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
