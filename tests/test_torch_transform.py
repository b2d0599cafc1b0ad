"""The port's eager staged transform (intfftk_tpu_torch.ops.transform)
against golden fft_int and the JAX XLA staged plan, exactly."""

import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int, random_stimulus
from intfftk_tpu.golden.float_model import bitrev_indices
from intfftk_tpu.ops.pallas_fft import _pack_tables
from intfftk_tpu.ops.transform import FFTPlan as JaxFFTPlan
from intfftk_tpu_torch.ops.transform import FFTPlan, bitrev_last, pack_tables

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


def _check(cfg, re, im):
    yr, yi = FFTPlan(cfg)(torch.as_tensor(re), torch.as_tensor(im))
    gr, gi = fft_int(re, im, cfg)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
    jr, ji = JaxFFTPlan(cfg)(re, im)
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr, np.int64))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji, np.int64))


@pytest.mark.parametrize("n", [8, 64, 1024])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_fft_stages_bitexact(n, mode, rounding):
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    re, im = random_stimulus(n, 16, seed=n, batch=(3,))
    _check(cfg, re, im)


@pytest.mark.parametrize("mode,rounding", MODES)
def test_fft_stages_fullscale(mode, rounding):
    """Full-scale most-negative stimulus: the round-mode difference wrap
    and the INT32_MIN guard of neg_guarded at a 32-bit data path."""
    dw = 32 if mode == "scaled" else 24
    cfg = FFTConfig(n=256, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=25)
    lim = 1 << (dw - 1)
    re = np.full((2, 256), -lim, np.int64)
    re[:, ::3] = lim - 1
    im = np.random.default_rng(5).integers(-lim, lim, (2, 256))
    _check(cfg, re, im)


def test_bypass_fly():
    cfg = FFTConfig(n=128, bypass_fly=True)
    re, im = random_stimulus(128, 16, seed=5, batch=(2,))
    _check(cfg, re, im)


def test_pack_tables_match_jax():
    cfg = FFTConfig(n=4096, twiddle_width=18)
    for ours, theirs in zip(pack_tables(cfg), _pack_tables(cfg, False)):
        np.testing.assert_array_equal(ours, theirs[:, 0])


def test_bitrev_last_is_the_gather():
    x = torch.arange(3 * 512).reshape(3, 512)
    rev = torch.as_tensor(bitrev_indices(512))
    assert torch.equal(bitrev_last(x), x[:, rev])


def test_not_ported_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FFTPlan(FFTConfig(n=64), inverse=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FFTPlan(FFTConfig(n=64, mode="unscaled", data_width=30))
