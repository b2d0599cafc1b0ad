"""The port's wide (> 32-bit) data path against the golden model and the JAX
wide plans, exactly: the int64 product (intmath.cmult_exact), the staged
WideFFTPlan, the wide pass forms of fused_pass (its plain version on the
CPU), PallasWideFFTPlan and the wide LargeFFTPlan.

The JAX package carries wide values as two int32 planes, hi * 2^24 + lo,
values in [-2^55, 2^55); the port carries int64 (64 bits).  The
plane-level JAX functions are fed and read through
convert.planes_from_int64 and int64_from_planes.  Above 56-bit outputs only the golden model is the
reference (ROADMAP §C)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int
from intfftk_tpu.golden.four_step import four_step_int
from intfftk_tpu.ops import pallas_fft as jp
from intfftk_tpu.ops import transform as jt
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.convert import (int64_from_planes, planes_from_int64,
                                       tables_from_jax)
from intfftk_tpu_torch.ops import transform as tt
from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan, circle_table,
                                              fused_pass,
                                              fused_pass_reference)
from intfftk_tpu_torch.ops.intmath import cmult_exact
from intfftk_tpu_torch.ops.single_pass import PallasWideFFTPlan
from intfftk_tpu_torch.ops.transform import WideFFTPlan, pack_tables

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


def rand_wide(width, shape, seed):
    """Random signed ``width``-bit values; the first item is the full-scale
    pattern that drives the round-mode difference to +2^(w-1), and the
    extremes are salted in (tests/test_wide.py:26-32)."""
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 1)
    v = rng.integers(-lim, lim, shape, dtype=np.int64)
    v[0] = -lim
    v[0, ..., ::3] = lim - 1
    flat = v.reshape(-1)
    flat[1], flat[-1] = -lim, lim - 1
    return v


def _np(t):
    return t.numpy().astype(np.int64)


def _golden64(g):
    """Golden output (int64 or object arrays) as int64."""
    return np.asarray(g).astype(np.int64)


# ------------------------------------------------------------ the product

def _pywrap(v, w):
    m = 1 << (w - 1)
    return ((v + m) & ((1 << w) - 1)) - m


@pytest.mark.parametrize("dw", [31, 33, 45, 52, 63])
@pytest.mark.parametrize("tw", [16, 18, 19, 25, 27])
def test_cmult_exact_wide(dw, tw):
    """cmult_exact on int64 data against Python-int arithmetic, with the
    output register's wrap (tests/test_wide.py:63-82), plain and
    conjugated; at 63-bit data times a 27-bit twiddle the product-sum is
    91 bits."""
    shift = tw - 1 if tw < 19 else tw - 2
    mag = (1 << (tw - 1)) - 1 if tw < 18 else (1 << (tw - 2)) - 1
    rng = np.random.default_rng(dw * 100 + tw)
    br, bi = rand_wide(dw, (2, 129), dw + tw)
    c = rng.integers(-mag, mag + 1, 129)
    d = rng.integers(-mag, mag + 1, 129)
    c[:2], d[:2] = [mag, -mag], [-mag, mag]
    for conj in (False, True):
        dd = -d if conj else d
        gr = [_pywrap((int(a) * int(x) - int(b) * int(y)) >> shift, dw)
              for a, b, x, y in zip(br, bi, c, dd)]
        gi = [_pywrap((int(b) * int(x) + int(a) * int(y)) >> shift, dw)
              for a, b, x, y in zip(br, bi, c, dd)]
        yr, yi = cmult_exact(*(torch.as_tensor(v) for v in (br, bi, c, d)),
                             shift, dw, conj=conj, twiddle_width=tw)
        assert yr.tolist() == gr and yi.tolist() == gi


# ------------------------------------------------------- the staged plan

WIDE_CASES = [
    # (n, mode, rounding, dw, tw), all with output width > 32
    # (tests/test_wide.py:87-95)
    (256, "unscaled", "truncate", 30, 16),
    (1024, "unscaled", "truncate", 24, 25),
    (64, "unscaled", "truncate", 32, 16),
    (256, "scaled", "truncate", 40, 16),
    (256, "scaled", "round", 40, 18),
    (4096, "unscaled", "truncate", 22, 16),
]


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n,mode,rounding,dw,tw", WIDE_CASES)
def test_wide_plan_vs_golden_and_jax(n, mode, rounding, dw, tw, inverse):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=tw)
    re, im = rand_wide(dw, (2, 2, n), n + dw)
    plan = tt.make_plan(P(cfg), inverse=inverse)
    assert isinstance(plan, WideFFTPlan)
    yr, yi = plan(torch.as_tensor(re), torch.as_tensor(im))
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    np.testing.assert_array_equal(_np(yr), _golden64(gr))
    np.testing.assert_array_equal(_np(yi), _golden64(gi))
    jr, ji = jt.WideFFTPlan(cfg, inverse=inverse)(re, im)
    np.testing.assert_array_equal(_np(yr), jr)
    np.testing.assert_array_equal(_np(yi), ji)


def test_make_plan_dispatch():
    narrow = tt.make_plan(P(FFTConfig(n=256, mode="scaled", data_width=16)))
    wide = tt.make_plan(P(FFTConfig(n=256, mode="unscaled", data_width=30)))
    assert type(narrow) is tt.FFTPlan and isinstance(wide, WideFFTPlan)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_wide_bypass_fly(inverse):
    cfg = FFTConfig(n=64, mode="unscaled", data_width=30, bypass_fly=True)
    re, im = rand_wide(30, (2, 2, 64), 5)
    yr, yi = WideFFTPlan(P(cfg), inverse=inverse)(torch.as_tensor(re),
                                                torch.as_tensor(im))
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    np.testing.assert_array_equal(_np(yr), gr)
    np.testing.assert_array_equal(_np(yi), gi)
    assert sorted(_np(yr)[0].tolist()) == sorted(re[0].tolist())


@pytest.mark.parametrize("fly_fwd,fly_inv", [(True, True), (False, True),
                                             (True, False)])
def test_wide_pair(fly_fwd, fly_inv):
    """The unscaled FFT->IFFT pair whose inverse outgrows 32 bits (n = 256,
    20-bit data, 25-bit twiddles: 28 -> 36) and its knockouts == the JAX
    pair == the golden composition (tests/test_wide.py:130-147); the
    roundtrip is about n * x."""
    n = 256
    cfg = FFTConfig(n=n, mode="unscaled", data_width=20, twiddle_width=25)
    re, im = rand_wide(16, (2, 2, n), 7)
    yr, yi = tt.fft_ifft_pair(re, im, P(cfg), fly_fwd, fly_inv)
    jr, ji = jt.fft_ifft_pair(re, im, cfg, fly_fwd, fly_inv)
    np.testing.assert_array_equal(_np(yr), np.asarray(jr, np.int64))
    np.testing.assert_array_equal(_np(yi), np.asarray(ji, np.int64))
    fcfg = dataclasses.replace(cfg, bypass_fly=not fly_fwd)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width,
                               bypass_fly=not fly_inv)
    gr, gi = fft_int(*fft_int(re, im, fcfg), icfg, inverse=True)
    np.testing.assert_array_equal(_np(yr), gr)
    np.testing.assert_array_equal(_np(yi), gi)
    if fly_fwd and fly_inv:
        nz = re[1] != 0
        assert abs(np.median(_np(yr)[1][nz] / re[1][nz]) - n) < 0.5


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n,dw,out", [(256, 52, 60), (64, 51, 57)])
def test_wide_60_bits_vs_golden(n, dw, out, inverse):
    """Unscaled outputs of 60 bits (n = 256, 52-bit data) and 57 bits
    (n = 64, 51-bit data), the narrowest at which the JAX planes go wrong
    on full-scale stimuli (ROADMAP §C); the port's int64 gives the golden
    bits, constant full-scale rows (the full growth at bin 0) included."""
    cfg = FFTConfig(n=n, mode="unscaled", data_width=dw)
    assert cfg.output_width == out
    re, im = rand_wide(dw, (2, 3, n), out)
    lim = 1 << (dw - 1)
    re[1, 0], im[1, 0], re[1, 1], im[1, 1] = -lim, lim - 1, lim - 1, -lim
    yr, yi = tt.fft(re, im, P(cfg)) if not inverse else tt.ifft(re, im, P(cfg))
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    assert gr.dtype == object              # golden's exact Python ints
    np.testing.assert_array_equal(_np(yr), _golden64(gr))
    np.testing.assert_array_equal(_np(yi), _golden64(gi))


def test_wider_than_64_raises():
    """An output above 64 bits does not fit the int64 register."""
    cfg = FFTConfig(n=8192, mode="unscaled", data_width=52)    # 65 bits
    z = np.zeros((1, 8192), np.int64)
    for run in (tt.make_plan, WideFFTPlan, lambda c: tt.fft(z, z, c)):
        with pytest.raises(NotImplementedError, match="int64"):
            run(P(cfg))


# ------------------------------------------------------ the pass forms

# (name, mode, rounding, dw, tw, R, inverse, natural, epi, wide_in)
PASS_FORMS = [
    ("widen_epi_fwd_nat", "unscaled", "truncate", 32, 20, 256, False, True,
     True, False),
    ("widen_epi_inv_raw", "unscaled", "truncate", 30, 16, 64, True, False,
     True, False),
    ("widen_fwd_nat", "unscaled", "truncate", 32, 16, 256, False, True,
     False, False),
    ("wide_epi_fwd_nat", "unscaled", "truncate", 40, 27, 64, False, True,
     True, True),
    ("wide_fwd_raw", "scaled", "truncate", 48, 18, 256, False, False, False,
     True),
    ("wide_inv_nat", "scaled", "round", 44, 20, 256, True, True, False,
     True),
    ("wide_epi_inv_raw", "scaled", "round", 52, 27, 128, True, False, True,
     True),
]


@pytest.mark.parametrize("name,mode,rounding,dw,tw,r,inverse,natural,epi,"
                         "wide_in", PASS_FORMS,
                         ids=[f[0] for f in PASS_FORMS])
def test_wide_pass_vs_jax(name, mode, rounding, dw, tw, r, inverse, natural,
                          epi, wide_in):
    """fused_pass_reference in each wide form == JAX _FusedPass(wide_in,
    wide_out, interpret) at [3, R, 40]: int32 -> int64 (the widening pass,
    with the epilogue and turned store, or plain), int64 -> int64 (both
    directions and orders), full-scale stimuli; 52-bit data with 27-bit
    twiddles is the 80-bit product-sum.  On the CPU fused_pass takes the
    same plain version and counts no launch."""
    c, nb = 40, 3
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=tw)
    assert cfg.output_width > 32
    xr, xi = (rand_wide(dw, (nb, r, c), r + dw + k) for k in (0, 1))
    order = "natural" if natural else "raw"
    e = (tuple(torch.as_tensor(t) for t in circle_table(
        P(dataclasses.replace(cfg, n=r * 64)), r, c, inverse, order))
        if epi else None)
    jpass = jp._FusedPass(cfg, inverse, wide_in=wide_in, wide_out=True,
                          has_epi=epi, transpose_out=epi, interpret=True,
                          spectrum_rows="natural" if natural else "bitrev")
    if wide_in:
        jx = [tuple(map(jnp.asarray, planes_from_int64(v))) for v in (xr, xi)]
    else:
        jx = [(jnp.asarray(v, jnp.int32),) for v in (xr, xi)]
    jr, ji = jpass.apply(jpass.consts, *jx, epi=tuple(
        jnp.asarray(t.numpy()) for t in e) if epi else None)
    in_dt = torch.int64 if wide_in else torch.int32
    x = [torch.as_tensor(v).to(in_dt) for v in (xr, xi)]
    tables = tuple(torch.as_tensor(t) for t in pack_tables(P(cfg)))
    kw = dict(epi=e, transpose_out=epi, inverse=inverse, natural=natural,
              out_dtype=torch.int64)
    yr, yi = fused_pass_reference(*x, P(cfg), tables, **kw)
    assert yr.dtype == torch.int64
    assert torch.equal(yr, int64_from_planes(*jr))
    assert torch.equal(yi, int64_from_planes(*ji))
    before = fused_pass.launches
    wr, wi = fused_pass(*x, P(cfg), tables, **kw)
    assert torch.equal(wr, yr) and torch.equal(wi, yi)
    assert fused_pass.launches == before


def test_wide_pass_rejects():
    """int64 blocks take no in-kernel synthesis and no 2-D tables; every
    block holds its output width; int64 -> int32 is no pass."""
    cfg = FFTConfig(n=64, mode="unscaled", data_width=30)
    tables = tuple(torch.as_tensor(t) for t in pack_tables(P(cfg)))
    x = torch.zeros(2, 64, 8, dtype=torch.int64)
    with pytest.raises(TypeError):
        fused_pass(x, x, P(cfg), tables, transpose_out=False,
                   out_dtype=torch.int32)
    with pytest.raises(ValueError):       # a 36-bit output in int32 blocks
        fused_pass(x.int(), x.int(), P(cfg), tables, transpose_out=False)
    t2 = tuple(torch.zeros(64, 8, dtype=torch.int32) for _ in range(2))
    with pytest.raises(ValueError):
        fused_pass(x, x, P(cfg), None, tables_2d=t2, transpose_out=False)


def test_planes_roundtrip():
    v = rand_wide(55, (3, 17), 3)
    lo, hi = planes_from_int64(torch.as_tensor(v))
    assert lo.dtype == hi.dtype == np.int32 and lo.min() >= 0
    np.testing.assert_array_equal(int64_from_planes(lo, hi).numpy(), v)
    from intfftk_tpu.ops.wideint import wide_from_i64_np
    jl, jh = wide_from_i64_np(v)
    np.testing.assert_array_equal(lo, jl)
    np.testing.assert_array_equal(hi, jh)


# ------------------------------------------------- PallasWideFFTPlan (K5)

@functools.cache
def _jax_wide_single(cfg, inverse, order):
    return jp.PallasWideFFTPlan(cfg, inverse=inverse, order=order,
                                interpret=True)


@pytest.mark.parametrize("order", ["natural", "bitrev"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n,mode,rounding,dw,tw", [
    (256, "scaled", "round", 40, 18), (1024, "unscaled", "truncate", 24, 25)])
def test_pallas_wide_plan_vs_jax(n, mode, rounding, dw, tw, inverse, order):
    """PallasWideFFTPlan on an [n, 128] tile == the JAX plan (interpret)
    (tests/test_wide.py:152-169); natural order also == fft_int."""
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=tw)
    re, im = (rand_wide(dw, (128, n), n + k).T.copy() for k in (0, 1))
    plan = PallasWideFFTPlan(P(cfg), inverse=inverse, order=order, device="cpu")
    before = fused_pass.launches
    yr, yi = plan(torch.as_tensor(re), torch.as_tensor(im))
    assert fused_pass.launches == before and yr.dtype == torch.int64
    jplan = _jax_wide_single(cfg, inverse, order)
    jr, ji = jplan(re, im)
    np.testing.assert_array_equal(_np(yr), jr)
    np.testing.assert_array_equal(_np(yi), ji)
    if order == "natural":
        gr, gi = fft_int(re.T, im.T, cfg, inverse=inverse)
        np.testing.assert_array_equal(_np(yr), gr.T)
        np.testing.assert_array_equal(_np(yi), gi.T)
    plan2 = PallasWideFFTPlan(P(cfg), inverse=inverse, order=order, device="cpu")
    plan2.load_state_dict(tables_from_jax(jax.tree_util.tree_map(
        np.asarray, jplan.consts)))
    for name, t in plan.state_dict().items():
        assert torch.equal(plan2.state_dict()[name], t)


def test_pallas_wide_plan_ragged_and_guards():
    """Any B >= 1 (the kernel masks its tail tile); n > 4096 and outputs
    above 64 bits raise."""
    cfg = FFTConfig(n=64, mode="unscaled", data_width=40, twiddle_width=27)
    re, im = (rand_wide(40, (3, 64), k).T.copy() for k in (8, 9))
    yr, yi = PallasWideFFTPlan(P(cfg), device="cpu")(torch.as_tensor(re), torch.as_tensor(im))
    gr, gi = fft_int(re.T, im.T, cfg)
    np.testing.assert_array_equal(_np(yr), gr.T)
    np.testing.assert_array_equal(_np(yi), gi.T)
    with pytest.raises(NotImplementedError):
        PallasWideFFTPlan(P(FFTConfig(n=8192, mode="unscaled", data_width=40)), device="cpu")
    with pytest.raises(ValueError):
        PallasWideFFTPlan(P(cfg), order="raw", device="cpu")


# ------------------------------------------------- the wide LargeFFTPlan

@functools.cache
def _jax_large(cfg, n1, n2, inverse, order):
    return jp.LargeFFTPlan(cfg, n1, n2, inverse=inverse, order=order,
                           interpret=True)


def _blocks(plan, xr, xi):
    """Flat [B, n] numpy -> the plan's output as flat int64 numpy."""
    nb = xr.shape[0]
    blk = lambda x: torch.as_tensor(x).to(plan.in_dtype).reshape(
        (nb,) + plan.block_in_shape).contiguous()
    yr, yi = plan.apply_blocks(blk(xr), blk(xi))
    assert yr.dtype == plan.out_dtype
    assert tuple(yr.shape) == (nb,) + plan.block_out_shape
    return _np(yr.reshape(nb, -1)), _np(yi.reshape(nb, -1))


def test_large_wide_chain_4096():
    """The config-2 chain at n = 4096 (32 x 128, bench.py:654-715): raw
    unscaled forward of 32-bit data with 20-bit twiddles (pass 1 widens to
    37 bits, out 44), the exact-unity 25-bit spectrum product, then the raw
    scaled/round inverse at 44 bits (wide_in, wide1, wide2).  Each half ==
    the JAX plan (interpret); the chain == four_step_int inverse o
    forward."""
    cfg = FFTConfig(n=4096, mode="unscaled", data_width=32, twiddle_width=20)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    fwd = LargeFFTPlan(P(cfg), order="raw", device="cpu")
    inv = LargeFFTPlan(P(icfg), fwd.n2, fwd.n1, inverse=True, order="raw", device="cpu")
    assert (fwd.n1, fwd.n2, fwd.epi_mode) == (32, 128, "host")
    assert (fwd.wide_in, fwd.wide1, fwd.wide2) == (False, True, True)
    assert (inv.wide_in, inv.wide1, inv.wide2) == (True, True, True)
    assert (fwd.in_dtype, fwd.mid_dtype, fwd.out_dtype) == (
        torch.int32, torch.int64, torch.int64)
    assert inv.block_in_shape == fwd.block_out_shape
    xr, xi = (rand_wide(32, (2, 4096), k) for k in (11, 12))
    yr, yi = _blocks(fwd, xr, xi)
    jf = _jax_large(cfg, None, None, False, "raw")
    assert (jf.n1, jf.n2, jf.wide1, jf.wide2) == (32, 128, True, True)
    jr, ji = jf(xr, xi)
    np.testing.assert_array_equal(yr, jr)
    np.testing.assert_array_equal(yi, ji)
    gr, gi = four_step_int(xr, xi, cfg, 32, 128)
    o = fwd.raw_spectrum_order()
    np.testing.assert_array_equal(yr, gr[:, o])
    np.testing.assert_array_equal(yi, gi[:, o])
    # the exact-unity spectrum product: (y * 2^23) >> 23 at 44 bits
    one = torch.full((1,), 1 << 23, dtype=torch.int64)
    pr, pi = cmult_exact(torch.as_tensor(yr), torch.as_tensor(yi), one,
                         torch.zeros(1, dtype=torch.int64), 23, 44,
                         twiddle_width=25)
    assert np.array_equal(_np(pr), yr) and np.array_equal(_np(pi), yi)
    zr, zi = _blocks(inv, _np(pr), _np(pi))
    ji_plan = _jax_large(icfg, 128, 32, True, "raw")
    assert (ji_plan.wide_in, ji_plan.wide1, ji_plan.wide2) == (True,) * 3
    kr, ki = ji_plan(yr, yi)
    np.testing.assert_array_equal(zr, kr)
    np.testing.assert_array_equal(zi, ki)
    hr, hi = four_step_int(gr, gi, icfg, 128, 32, inverse=True)
    np.testing.assert_array_equal(zr, hr)
    np.testing.assert_array_equal(zi, hi)


def test_large_wide_64k_widening_pass2():
    """64k unscaled 24-bit, 16-bit twiddles, natural (tests/test_wide.py:
    172-188): pass 1 ends at 32 bits (int32), pass 2 widens to 40 (int64)
    with no epilogue; batch 1 == four_step_int."""
    cfg = FFTConfig(n=1 << 16, mode="unscaled", data_width=24,
                    twiddle_width=16)
    plan = LargeFFTPlan(P(cfg), device="cpu")
    assert (plan.wide_in, plan.wide1, plan.wide2) == (False, False, True)
    assert (plan.mid_dtype, plan.out_dtype) == (torch.int32, torch.int64)
    xr, xi = (rand_wide(24, (1, 1 << 16), k) for k in (13, 14))
    yr, yi = plan(torch.as_tensor(xr), torch.as_tensor(xi))
    assert yr.dtype == torch.int64
    gr, gi = four_step_int(xr, xi, cfg, 256, 256)
    np.testing.assert_array_equal(_np(yr), gr)
    np.testing.assert_array_equal(_np(yi), gi)


def test_large_wide_epi_synth():
    """epi_synth="auto" takes the host table where pass 1 is wide, though
    can_synth holds (the JAX rule, pallas_fft.py:1617); "device" and
    "inkernel" raise there.  A narrow pass 1 keeps "device"."""
    cfg = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                    twiddle_width=16)
    plan = LargeFFTPlan(P(cfg), device="cpu")
    assert plan.wide1 and plan.epi_mode == "host"
    for mode in ("device", "inkernel"):
        with pytest.raises(ValueError, match="32 bits"):
            LargeFFTPlan(P(cfg), epi_synth=mode, device="cpu")
    narrow1 = LargeFFTPlan(P(dataclasses.replace(cfg, data_width=24)), device="cpu")
    assert not narrow1.wide1 and narrow1.wide2
    assert narrow1.epi_mode == "device"


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_large_wide_monolithic_raises(inverse):
    cfg = FFTConfig(n=1 << 12, mode="unscaled", data_width=24)
    with pytest.raises(NotImplementedError, match="monolithic"):
        LargeFFTPlan(P(cfg), inverse=inverse, schedule="monolithic", device="cpu")
    with pytest.raises(NotImplementedError, match="monolithic"):
        jp.LargeFFTPlan(cfg, inverse=inverse, schedule="monolithic",
                        interpret=True)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_tables_from_jax_wide(inverse):
    """The consts of the wide JAX plans of the chain convert to the port's
    buffers (the same int32 tables), and a plan loaded with them gives the
    same bits."""
    cfg = FFTConfig(n=4096, mode="unscaled", data_width=32, twiddle_width=20)
    if inverse:
        cfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                                  data_width=44)
        args = (cfg, 128, 32, True, "raw")
    else:
        args = (cfg, None, None, False, "raw")
    jplan = _jax_large(*args)
    tables = tables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jplan.consts))
    assert set(tables) == {"w1r", "w1i", "w2r", "w2i", "er", "ei"}
    plan = LargeFFTPlan(P(cfg), *args[1:3], inverse=inverse, order="raw", device="cpu")
    for name, t in tables.items():
        assert torch.equal(getattr(plan, name), t), name
    loaded = LargeFFTPlan(P(cfg), *args[1:3], inverse=inverse, order="raw", device="cpu")
    for name in tables:
        getattr(loaded, name).zero_()
    loaded.load_tables(tables)
    xr, xi = (rand_wide(cfg.data_width, (1, 4096), k) for k in (15, 16))
    for a, b in zip(_blocks(plan, xr, xi), _blocks(loaded, xr, xi)):
        np.testing.assert_array_equal(a, b)
