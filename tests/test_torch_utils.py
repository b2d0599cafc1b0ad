"""The port's copies of the JAX package's utilities against the originals,
exactly: utils.dat_io (files each side reads alike), utils.lanes (every
function, on numpy inputs and on torch tensors) and runtime.native (the
same C++ golden engine through the port's bindings, skipped exactly where
tests/test_native.py skips)."""

import numpy as np
import pytest
import torch

import intfftk_tpu.utils.dat_io as jdat
import intfftk_tpu.utils.lanes as jlanes
import intfftk_tpu_torch.utils.dat_io as pdat
import intfftk_tpu_torch.utils.lanes as planes
from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int, random_stimulus
from intfftk_tpu_torch.convert import config_from_jax

try:
    from intfftk_tpu.runtime import NativeGolden, native_available
    HAVE = native_available()
except Exception:
    HAVE = False

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


@pytest.mark.parametrize("ncols", [1, 2, 4])
def test_dat_io_roundtrip(tmp_path, ncols):
    rng = np.random.default_rng(ncols)
    cols = [rng.integers(-(1 << 31), 1 << 31, 50) for _ in range(ncols)]
    pdat.write_dat(tmp_path / "p.dat", *cols)
    jdat.write_dat(tmp_path / "j.dat", *cols)
    assert (tmp_path / "p.dat").read_bytes() == (tmp_path / "j.dat").read_bytes()
    for reader in (pdat.read_dat, jdat.read_dat):
        got = reader(tmp_path / "p.dat")
        assert len(got) == ncols
        for a, b in zip(got, cols):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pdat.write_dat(tmp_path / "bad.dat", cols[0], cols[0][:-1])


def _lane_calls(x, y):
    """Every public lanes function on (x, y) [..., 16] and [..., 8] lanes."""
    return {
        "split_halves": lambda m: m.split_halves(x),
        "merge_halves": lambda m: m.merge_halves(x[..., :8], y[..., :8]),
        "interleave2_to_halves": lambda m: m.interleave2_to_halves(
            x[..., :8], y[..., :8]),
        "halves_to_interleave2": lambda m: m.halves_to_interleave2(
            x[..., :8], y[..., :8]),
        "_riffle": lambda m: m._riffle(x[..., :8], y[..., :8]),
        "bitrev_pair": lambda m: m.bitrev_pair(x),
    }


@pytest.mark.parametrize("name", list(_lane_calls(None, None)))
@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_lanes(name, as_torch):
    rng = np.random.default_rng(5)
    x, y = (rng.integers(-1000, 1000, (3, 16)) for _ in range(2))
    want = _lane_calls(x, y)[name](jlanes)
    px, py = (torch.as_tensor(v) for v in (x, y)) if as_torch else (x, y)
    got = _lane_calls(px, py)[name](planes)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(want, got):
        assert isinstance(b, torch.Tensor if as_torch else np.ndarray)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lanes_indices_and_xp():
    for n in (8, 64, 1024):
        np.testing.assert_array_equal(planes.bitrev_pair_indices(n),
                                      jlanes.bitrev_pair_indices(n))
    assert planes._xp(np.zeros(2)) is np
    assert planes._xp(torch.zeros(2)) is torch


@pytest.mark.skipif(not HAVE, reason="native engine unavailable")
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_native_golden(mode, rounding, inverse):
    from intfftk_tpu_torch.runtime import NativeGolden as PortNative
    from intfftk_tpu_torch.runtime import native_available as port_available
    assert port_available()
    cfg = FFTConfig(n=256, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    re, im = random_stimulus(256, 16, seed=2, batch=(3,))
    pr, pi = PortNative().fft(re, im, config_from_jax(cfg), inverse=inverse)
    jr, ji = NativeGolden().fft(re, im, cfg, inverse=inverse)
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    for a, b, g in ((pr, jr, gr), (pi, ji, gi)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, g)
    for p in (3, 10):
        for x, y in zip(PortNative().stage_twiddles(p, 18),
                        NativeGolden().stage_twiddles(p, 18)):
            np.testing.assert_array_equal(x, y)
