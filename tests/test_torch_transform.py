"""The port's eager staged transform (intfftk_tpu_torch.ops.transform)
against golden fft_int and the JAX XLA staged plan, exactly, in both
directions."""

import dataclasses

import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int, int_model, random_stimulus
from intfftk_tpu.golden.float_model import bitrev_indices
from intfftk_tpu.ops import transform as jt
from intfftk_tpu.ops import pallas_fft as jp
from intfftk_tpu.ops.pallas_fft import _pack_tables
from intfftk_tpu.ops.transform import FFTPlan as JaxFFTPlan
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.ops import transform as tt
from intfftk_tpu_torch.ops.transform import (FFTPlan, bitrev_last,
                                             pack_tables, pack_tables_2d)

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


def _check(cfg, re, im, inverse=False):
    yr, yi = FFTPlan(P(cfg), inverse=inverse)(torch.as_tensor(re),
                                           torch.as_tensor(im))
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
    jr, ji = JaxFFTPlan(cfg, inverse=inverse)(re, im)
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr, np.int64))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji, np.int64))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [8, 64, 1024])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_fft_stages_bitexact(n, mode, rounding, inverse):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    re, im = random_stimulus(n, 16, seed=n, batch=(3,))
    _check(cfg, re, im, inverse)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_fft_stages_fullscale(mode, rounding, inverse):
    """Full-scale most-negative stimulus: the round-mode difference wrap
    and the INT32_MIN guard of neg_guarded at a 32-bit data path."""
    dw = 32 if mode == "scaled" else 24
    cfg = FFTConfig(n=256, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=25)
    lim = 1 << (dw - 1)
    re = np.full((2, 256), -lim, np.int64)
    re[:, ::3] = lim - 1
    im = np.random.default_rng(5).integers(-lim, lim, (2, 256))
    _check(cfg, re, im, inverse)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_bypass_fly(inverse):
    cfg = FFTConfig(n=128, bypass_fly=True)
    re, im = random_stimulus(128, 16, seed=5, batch=(2,))
    _check(cfg, re, im, inverse)


@pytest.mark.parametrize("p", [0, 1, 2, 6])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_stage_edges(mode, rounding, p):
    """One DIF and one DIT stage on every pair of int32 edge values at a
    32-bit (scaled) or 24-bit (unscaled) width, against the golden
    butterflies: the round-mode difference wrap, and neg_guarded at
    INT32_MIN on the order-1 odd lane (the inverse takes B * j)."""
    dw = 32 if mode == "scaled" else 24
    cfg = FFTConfig(n=256, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=25)
    lim = 1 << (dw - 1)
    edge = np.array([-lim, -lim + 1, -1, 0, 1, lim - 2, lim - 1], np.int64)
    h = 1 << p
    a = np.repeat(edge, edge.size)
    b = np.tile(edge, edge.size)
    m = -(-a.size // h) * h
    lanes = [np.resize(v, m).reshape(-1, h) for v in (a, b, b[::-1], a)]
    ar, br, ai, bi = lanes
    k = np.arange(h)
    w_re, w_im = (torch.as_tensor(t)[h: 2 * h] for t in pack_tables(P(cfg)))
    for ours, golden in ((tt.dif_stage, int_model.dif_butterfly_int),
                         (tt.dit_stage, int_model.dit_butterfly_int)):
        got = ours(*(torch.as_tensor(v) for v in (ar, ai, br, bi)), P(cfg),
                   dw, p, w_re, w_im)
        want = golden(ar, ai, br, bi, k, p, cfg, dw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_raw_order(inverse):
    """natural=False leaves the spectrum side bit-reversed: the forward
    emits the bit-reversal of its natural output, the inverse consumes
    it."""
    cfg = FFTConfig(n=512, mode="scaled", rounding="round")
    re, im = random_stimulus(512, 16, seed=6, batch=(2,))
    tables = [torch.as_tensor(t) for t in pack_tables(P(cfg))]
    x = [torch.as_tensor(v) for v in (re, im)]
    rev = bitrev_indices(512)
    nat = tt.fft_stages(*x, P(cfg), *tables, inverse=inverse)
    if inverse:
        raw = tt.fft_stages(*(v[:, rev] for v in x), P(cfg), *tables,
                            inverse=True, natural=False)
        want = nat
    else:
        raw = tt.fft_stages(*x, P(cfg), *tables, natural=False)
        want = [v[:, rev] for v in nat]
    for g, w in zip(raw, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("fly_fwd,fly_inv", [(True, True), (False, True),
                                             (True, False)])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_fft_ifft_pair(mode, rounding, fly_fwd, fly_inv):
    """The widened roundtrip and its knockouts equal the JAX pair and the
    golden composition."""
    cfg = FFTConfig(n=128, mode=mode, rounding=rounding, data_width=12,
                    twiddle_width=16)
    re, im = random_stimulus(128, 12, seed=7, batch=(2,))
    yr, yi = tt.fft_ifft_pair(re, im, P(cfg), fly_fwd, fly_inv)
    jr, ji = jt.fft_ifft_pair(re, im, cfg, fly_fwd, fly_inv)
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr, np.int64))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji, np.int64))
    fcfg = dataclasses.replace(cfg, bypass_fly=not fly_fwd)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width,
                               bypass_fly=not fly_inv)
    gr, gi = fft_int(*fft_int(re, im, fcfg), icfg, inverse=True)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)


def test_fft_ifft_functions():
    cfg = FFTConfig(n=64, mode="scaled", rounding="truncate")
    re, im = random_stimulus(64, 16, seed=8, batch=(3,))
    for ours, inverse in ((tt.fft, False), (tt.ifft, True)):
        yr, yi = ours(re, im, P(cfg))
        gr, gi = fft_int(re, im, cfg, inverse=inverse)
        np.testing.assert_array_equal(yr.numpy(), gr)
        np.testing.assert_array_equal(yi.numpy(), gi)


def test_pack_tables_match_jax():
    cfg = FFTConfig(n=4096, twiddle_width=18)
    for ours, theirs in zip(pack_tables(P(cfg)), _pack_tables(cfg, False)):
        np.testing.assert_array_equal(ours, theirs[:, 0])


def test_pack_tables_2d_match_jax():
    """The monolithic 2-D stage tables == ``_pack_tables_2d``, Taylor
    stages included (64 x 128 at n = 8192)."""
    cfg = FFTConfig(n=1 << 13, twiddle_width=16, twiddle_gen="taylor_new")
    for ours, theirs in zip(pack_tables_2d(P(cfg), 64, 128),
                            jp._pack_tables_2d(cfg, 64, 128)):
        assert ours.dtype == np.int32
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("natural", [True, False], ids=["natural", "raw"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_fft_stages_2d_vs_jax(mode, rounding, inverse, natural):
    """fft_stages_2d on the [C, n1] view == JAX ``_transform_rows_2d`` on
    the [n1, C] tile (every stage multiplies, q = 0 and 1 included), with
    full-scale adversarial columns, 16 x 128 of n = 2048."""
    n1, n2 = 16, 128
    full = FFTConfig(n=n1 * n2, mode=mode, rounding=rounding, data_width=16,
                     twiddle_width=16)
    cfg = dataclasses.replace(full, n=n1)
    t = pack_tables_2d(full, n1, n2)
    re, im = random_stimulus(n1, 16, seed=11, batch=(n2,))
    re[::4] = -(1 << 15)
    re[::4, ::3] = (1 << 15) - 1
    yr, yi = tt.fft_stages_2d(torch.as_tensor(re), torch.as_tensor(im), P(cfg),
                              *(torch.as_tensor(v) for v in t),
                              inverse=inverse, natural=natural)
    import jax.numpy as jnp
    jr, ji = jp._transform_rows_2d(
        jnp.asarray(re.T, jnp.int32), jnp.asarray(im.T, jnp.int32), cfg,
        inverse, *(jnp.asarray(v) for v in t),
        jp._cmult_plans_all(cfg, inverse, 0),
        spectrum_rows="natural" if natural else "bitrev")
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr).T)
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji).T)


def test_bitrev_last_is_the_gather():
    x = torch.arange(3 * 512).reshape(3, 512)
    rev = torch.as_tensor(bitrev_indices(512))
    assert torch.equal(bitrev_last(x), x[:, rev])


def test_not_ported_raises():
    """A 36-bit data path is carried now (the wide plan, golden bits); an
    output above the int64 register (65 bits) is not and raises."""
    cfg = FFTConfig(n=64, mode="unscaled", data_width=30)
    re, im = random_stimulus(64, 30, seed=9, batch=(2,))
    re[0, ::2] = -(1 << 29)
    plan = FFTPlan(P(cfg))
    assert isinstance(tt.make_plan(P(cfg)), tt.WideFFTPlan)
    yr, yi = plan(torch.as_tensor(re), torch.as_tensor(im))
    gr, gi = fft_int(re, im, cfg)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
    with pytest.raises(NotImplementedError, match="int64"):
        FFTPlan(P(FFTConfig(n=8192, mode="unscaled", data_width=52)))


def test_wide_pair_raises():
    """The unscaled pair's inverse side outgrows 32 bits (16 + 2 * 10 = 36):
    it runs on the wide plan, bit-equal to the golden composition.  A pair
    whose inverse outgrows 64 bits (64k, 36-bit data: 52 -> 68) raises
    before any work."""
    cfg = FFTConfig(n=1024, mode="unscaled")
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    assert isinstance(tt.make_plan(P(icfg), inverse=True), tt.WideFFTPlan)
    re, im = random_stimulus(1024, 16, seed=10, batch=(1,))
    yr, yi = tt.fft_ifft_pair(re, im, P(cfg))
    gr, gi = fft_int(*fft_int(re, im, cfg), icfg, inverse=True)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
    big = FFTConfig(n=1 << 16, mode="unscaled", data_width=36)
    with pytest.raises(NotImplementedError, match="int64"):
        tt.fft_ifft_pair(np.zeros((1, 1 << 16)), np.zeros((1, 1 << 16)), P(big))
