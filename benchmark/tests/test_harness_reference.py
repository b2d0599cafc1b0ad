"""The frozen reference equals the port's golden model at tiny sizes, for
both configurations, and the control differs from it.

The port's golden model is what the port's own tests hold the port to;
the benchmark holds the port to this frozen copy instead, so a later
change to the port cannot move the yardstick.  These tests show that the
two agree today."""

import dataclasses

import numpy as np
import pytest

from benchmark import manifest, reference
from benchmark.builders import core_fft, overlap_save
from intfftk_tpu_torch import golden
from intfftk_tpu_torch.config import FFTConfig as PortConfig

from benchmark.tests.conftest import TINY


def _rng(seed=0):
    return np.random.default_rng(seed)


def _config(name, **over):
    return dict(manifest.cell(next(
        w["name"] for w in manifest.load()["workloads"]
        if w["config"] == name)).config, **TINY[name], **over)


@pytest.mark.parametrize("n1,n2", [(16, 16), (8, 32), (32, 32)])
@pytest.mark.parametrize("rounding", ["round", "truncate"])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_equals_port_golden(n1, n2, rounding, inverse):
    n = n1 * n2
    cfg = reference.FFTConfig(n=n, mode="scaled", rounding=rounding,
                              data_width=16, twiddle_width=16)
    port = PortConfig(**dataclasses.asdict(cfg))
    x = _rng(n).integers(-(1 << 15), 1 << 15, (2, 3, n))
    a = reference.four_step_int(x[0], x[1], cfg, n1, n2, inverse=inverse)
    b = golden.four_step_int(x[0], x[1], port, n1, n2, inverse=inverse)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("mode", ["scaled", "unscaled"])
def test_fft_int_equals_port_golden(mode):
    cfg = reference.FFTConfig(n=512, mode=mode, rounding="round",
                              data_width=16, twiddle_width=18)
    port = PortConfig(**dataclasses.asdict(cfg))
    x = _rng(1).integers(-(1 << 15), 1 << 15, (2, 4, 512))
    for u, v in zip(reference.fft_int(x[0], x[1], cfg),
                    golden.fft_int(x[0], x[1], port)):
        np.testing.assert_array_equal(u, v)


def test_core_config_equals_port_golden_on_the_cells_path():
    """The core configuration at its tiny size, through the builder's own
    reading of the file."""
    config = _config("core64k_round16")
    cfg = core_fft.reference_config(config)
    n1, n2 = config["factors"]
    x = _rng(2).integers(-(1 << 15), 1 << 15, (2, 5, cfg.n))
    port = PortConfig(**{k: config[k] for k in core_fft.CONFIG_KEYS})
    for u, v in zip(reference.four_step_int(x[0], x[1], cfg, n1, n2),
                    golden.four_step_int(x[0], x[1], port, n1, n2)):
        np.testing.assert_array_equal(u, v)


def test_conv_spec_and_overlap_save_equal_port_golden():
    config = _config("conv64k_fir8193")
    spec = overlap_save.reference_spec(config)
    port = golden.make_conv_spec(**{k: config[k]
                                    for k in overlap_save.SPEC_KEYS})
    assert dataclasses.asdict(spec) == dataclasses.asdict(port)
    h_re, h_im = overlap_save.taps(config, 5)
    x = _rng(3).integers(-(1 << 13), 1 << 13, (2, 3 * spec.payload))
    a = reference.overlap_save_int(x[0], x[1], h_re, h_im, spec)
    b = golden.overlap_save_int(x[0], x[1], h_re, h_im, port)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_overlap_save_blocks_equal_every_block():
    config = _config("conv64k_fir8193")
    spec = overlap_save.reference_spec(config)
    h_re, h_im = overlap_save.taps(config, 6)
    x = _rng(4).integers(-(1 << 13), 1 << 13, (2, 4 * spec.payload))
    whole = reference.overlap_save_int(x[0], x[1], h_re, h_im, spec)
    spectrum = reference.taps_spectrum_int(h_re, h_im, spec)
    blocks = [3, 0, 2]
    some = reference.overlap_save_blocks(x[0], x[1], spectrum, spec, blocks)
    for part, full in zip(some, whole):
        np.testing.assert_array_equal(
            part, full.reshape(4, spec.payload)[blocks])


def test_core_control_differs():
    """The core's control (RNDMODE=0: truncation, the step below the
    stated round-half-up) gives other bits on the cell's traffic."""
    config = _config("core64k_round16")
    n1, n2 = config["factors"]
    x = _rng(7).integers(-(1 << 15), 1 << 15, (2, 4, config["n"]))
    want = reference.four_step_int(x[0], x[1],
                                   core_fft.reference_config(config), n1, n2)
    ctl = reference.four_step_int(
        x[0], x[1], core_fft.reference_config(config, control=True), n1, n2)
    assert any(np.count_nonzero(a != b) for a, b in zip(want, ctl))


def test_conv_control_differs():
    """The convolution's control (the product and the inverse on int32,
    the container below the stated 44-bit product) gives other bits."""
    config = _config("conv64k_fir8193")
    spec = overlap_save.reference_spec(config)
    cspec = overlap_save.reference_spec(config, control=True)
    assert cspec.product_width == 32 < spec.product_width
    h_re, h_im = overlap_save.taps(config, 8)
    x = _rng(8).integers(-(1 << 13), 1 << 13, (2, 2 * spec.payload))
    want = reference.overlap_save_int(x[0], x[1], h_re, h_im, spec)
    ctl = reference.overlap_save_int(x[0], x[1], h_re, h_im, cspec)
    assert any(np.count_nonzero(a != b) for a, b in zip(want, ctl))
