"""The port's own copy of the NumPy spec (intfftk_tpu_torch.config and
intfftk_tpu_torch.golden) against the original in intfftk_tpu: every copied
public function gives array_equal results (or raises the same exception)
over the widths, modes and generators the port uses; the port's package
imports neither jax nor intfftk_tpu."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import intfftk_tpu.config as jc
import intfftk_tpu.golden as jg
import intfftk_tpu.golden.convolve as jconv
import intfftk_tpu.golden.four_step as jfs
import intfftk_tpu.golden.int_model as jim
import intfftk_tpu.golden.twiddle as jtw
import intfftk_tpu_torch.config as pc
import intfftk_tpu_torch.golden as pg
import intfftk_tpu_torch.golden.convolve as pconv
import intfftk_tpu_torch.golden.four_step as pfs
import intfftk_tpu_torch.golden.int_model as pim
import intfftk_tpu_torch.golden.twiddle as ptw
from intfftk_tpu_torch.convert import conv_spec_from_jax, config_from_jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]
GENS = ["auto", "rom", "taylor_new"]


def _outcome(fn, *args, **kw):
    """The arrays a call returns, or the type of what it raises."""
    try:
        out = fn(*args, **kw)
    except Exception as e:                                   # noqa: BLE001
        return type(e)
    return out if isinstance(out, tuple) else (out,)


def _same(a, b):
    if isinstance(a, type) or isinstance(b, type):
        assert a is b, (a, b)
        return
    assert len(a) == len(b)
    for u, v in zip(a, b):
        u, v = np.asarray(u), np.asarray(v)
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


def _both(cfg_kw):
    return jc.FFTConfig(**cfg_kw), pc.FFTConfig(**cfg_kw)


def _data(shape, w, seed):
    rng = np.random.default_rng(seed)
    lim = 1 << (w - 1)
    return rng.integers(-lim, lim, shape), rng.integers(-lim, lim, shape)


@pytest.mark.parametrize("gen", GENS)
@pytest.mark.parametrize("width", [16, 18, 20, 25, 27])
def test_stage_twiddles_int(width, gen):
    for p in range(1, 21):
        _same(_outcome(jtw.stage_twiddles_int, p, width, gen),
              _outcome(ptw.stage_twiddles_int, p, width, gen))


@pytest.mark.parametrize("gen", GENS + ["taylor_old"])
@pytest.mark.parametrize("n,width", [(64, 16), (4096, 16), (1 << 16, 20),
                                     (1 << 18, 16), (1 << 20, 17)])
def test_circle_twiddles_int(n, width, gen):
    _same(_outcome(jtw.circle_twiddles_int, n, width, gen),
          _outcome(ptw.circle_twiddles_int, n, width, gen))


def test_twiddle_helpers():
    assert (pc.TAYLOR_STAGE, pc.TAYLOR_COARSE_BITS) == (
        jc.TAYLOR_STAGE, jc.TAYLOR_COARSE_BITS)
    for w in (16, 17, 18, 20, 25, 27):
        assert ptw.magnitude(w) == jtw.magnitude(w)
        _same(ptw.quarter_table(9, w), jtw.quarter_table(9, w))
        _same(ptw.quarter_table(5, w), jtw.quarter_table(5, w))
    count = np.arange(1 << 10)
    for ser in ("old", "new"):
        for ii in range(0, 12):
            a = _outcome(jtw.taylor_mathpi, ii, ser)
            b = _outcome(ptw.taylor_mathpi, ii, ser)
            assert (a is b) if isinstance(a, type) else a[0] == b[0]
            _same(_outcome(jtw.taylor_mpi, count, ii, ser),
                  _outcome(ptw.taylor_mpi, count, ii, ser))
    for p in (0, 1, 5, 12):
        _same((jtw.stage_twiddles_float(p),), (ptw.stage_twiddles_float(p),))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_fft_int_and_four_step(mode, rounding, inverse):
    for kw, seed in ((dict(n=1024, data_width=16, twiddle_width=16), 1),
                     (dict(n=4096, data_width=24, twiddle_width=20,
                           twiddle_gen="taylor_new"), 2),
                     (dict(n=256, data_width=40, twiddle_width=25), 3)):
        j, p = _both(dict(kw, mode=mode, rounding=rounding))
        x = _data((2, kw["n"]), kw["data_width"], seed)
        _same(_outcome(jg.fft_int, *x, j, inverse=inverse),
              _outcome(pg.fft_int, *x, p, inverse=inverse))
        n1 = 16
        _same(_outcome(jg.four_step_int, *x, j, n1, kw["n"] // n1,
                       inverse=inverse),
              _outcome(pg.four_step_int, *x, p, n1, kw["n"] // n1,
                       inverse=inverse))
        assert pim.needs_object(p) == jim.needs_object(j)


def test_int_model_pieces():
    rng = np.random.default_rng(4)
    v = rng.integers(-(1 << 40), 1 << 40, 500)
    for w in (8, 16, 31, 32, 40, 63):
        _same((jim.wrap_width(v, w),), (pim.wrap_width(v, w),))
    _same((jim.neg_guarded(v),), (pim.neg_guarded(v),))
    _same((jim.round_half_up(v),), (pim.round_half_up(v),))
    a, b, c, d = (rng.integers(-(1 << 15), 1 << 15, 256) for _ in range(4))
    for shift, ow, wrap in ((14, 16, True), (15, 17, False), (0, 40, True)):
        _same(jim.cmult_int(a, b, c, d, shift, ow, wrap),
              pim.cmult_int(a, b, c, d, shift, ow, wrap))
    k = np.arange(256)
    for mode, rounding in MODES:
        j, p = _both(dict(n=1024, mode=mode, rounding=rounding))
        for order in (0, 1, 8):
            kk = k[:1 << order] if order < 8 else k
            args = [t[:kk.size] for t in (a, b, c, d)]
            for name in ("dif_butterfly_int", "dit_butterfly_int"):
                _same(getattr(jim, name)(*args, kk, order, j, 16),
                      getattr(pim, name)(*args, kk, order, p, 16))
    j, p = _both(dict(n=4096, twiddle_width=18))
    m = rng.integers(0, 4096, 256)
    _same(jfs.twiddle_apply_int(a, b, m, j, 20),
          pfs.twiddle_apply_int(a, b, m, p, 20))
    assert pfs.four_step_shapes(64, 128) == jfs.four_step_shapes(64, 128)
    x = rng.normal(size=4096) + 1j * rng.normal(size=4096)
    _same((jfs.four_step_float(x, 64, 64),), (pfs.four_step_float(x, 64, 64),))


def test_float_model_and_stimulus():
    for n in (8, 64, 4096):
        _same((jg.bitrev_indices(n),), (pg.bitrev_indices(n),))
    x = np.random.default_rng(5).normal(size=(2, 256)) * (1 + 1j)
    _same((jg.fft_dif_float(x),), (pg.fft_dif_float(x),))
    _same((jg.fft_dit_float(x),), (pg.fft_dit_float(x),))
    a, b = np.arange(32.0), np.arange(32.0) + 100
    for stg in range(1, 5):
        _same(jg.cross_commutate(a, b, stg, 64),
              pg.cross_commutate(a, b, stg, 64))
        _same(jg.cross_commutate_inv(a, b, stg, 64),
              pg.cross_commutate_inv(a, b, stg, 64))
    _same(jg.chirp_stimulus(1024, 16), pg.chirp_stimulus(1024, 16))
    _same(jg.random_stimulus(256, 12, seed=3, batch=(2,)),
          pg.random_stimulus(256, 12, seed=3, batch=(2,)))
    ref = x[0]
    assert pc.snr_db(ref, ref + 1e-3) == jc.snr_db(ref, ref + 1e-3)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_lane_model_and_sanitize(mode, rounding, inverse):
    j, p = _both(dict(n=256, mode=mode, rounding=rounding))
    x = _data((256,), 16, 6)
    _same(_outcome(jg.fft_int_lanes, *x, j, inverse=inverse),
          _outcome(pg.fft_int_lanes, *x, p, inverse=inverse))
    big = [8 * v for v in x]                    # out of the width contract
    for data in (x, big):
        rj = jg.check_overflow(*data, j, inverse=inverse)
        rp = pg.check_overflow(*data, p, inverse=inverse)
        assert isinstance(rp, pg.OverflowReport)
        assert (rp.stage_wraps, rp.total, rp.clean, str(rp)) == (
            rj.stage_wraps, rj.total, rj.clean, str(rj))


CONV_SPECS = [dict(n=256, taps_len=33, data_width=12, taps_width=12),
              dict(n=512, taps_len=65, rounding="round"),
              dict(n=1 << 13, taps_len=1 << 10),
              dict(n=1 << 14, taps_len=(1 << 11) + 1, twiddle_width=16,
                   max_product_width=44, max_spectrum_width=25),
              dict(n=1 << 16, taps_len=(1 << 13) + 1, twiddle_width=16,
                   max_product_width=44, max_spectrum_width=25),
              dict(n=256, taps_len=256), dict(n=256, taps_len=9,
                                              max_product_width=60),
              dict(n=1 << 16, taps_len=9, data_width=24),
              dict(n=4096, taps_len=9, max_product_width=44)]


@pytest.mark.parametrize("kw", CONV_SPECS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_make_conv_spec(kw):
    a, b = _outcome(jconv.make_conv_spec, **kw), _outcome(
        pconv.make_conv_spec, **kw)
    if isinstance(a, type):
        assert a is b is ValueError
        return
    (j,), (p,) = a, b
    assert isinstance(p, pconv.ConvSpec) and isinstance(p.cfg, pc.FFTConfig)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for name in ("n", "payload", "spectrum_width", "product_width",
                 "scale_log2"):
        assert getattr(p, name) == getattr(j, name)
    for name in ("fft_cfg", "ifft_cfg"):
        assert dataclasses.asdict(getattr(p, name)) == dataclasses.asdict(
            getattr(j, name))
    assert conv_spec_from_jax(j) == p and conv_spec_from_jax(p) is p


@pytest.mark.parametrize("kw", CONV_SPECS[:4], ids=["n256", "n512", "n8k",
                                                    "n16k_wide"])
def test_overlap_save_int(kw):
    j, p = jconv.make_conv_spec(**kw), pconv.make_conv_spec(**kw)
    rng = np.random.default_rng(7)
    h = [rng.integers(-(1 << 10), 1 << 10, j.taps_len) for _ in range(2)]
    x = [rng.integers(-(1 << 10), 1 << 10, (2, j.payload * 2 + 5))
         for _ in range(2)]
    _same(jconv.taps_spectrum_int(*h, j), pconv.taps_spectrum_int(*h, p))
    _same(jconv.overlap_save_int(*x, *h, j), pconv.overlap_save_int(*x, *h, p))


BAD_CONFIGS = [dict(n=12), dict(n=4), dict(mode="block"),
               dict(rounding="nearest"), dict(data_width=7),
               dict(data_width=53), dict(twiddle_width=15),
               dict(twiddle_width=28), dict(twiddle_gen="cordic")]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_fftconfig_raises_alike(kw):
    with pytest.raises(ValueError) as ej:
        jc.FFTConfig(**kw)
    with pytest.raises(ValueError) as ep:
        pc.FFTConfig(**kw)
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("kw", [
    dict(), dict(n=8), dict(n=1 << 19, mode="unscaled", data_width=32,
                            twiddle_width=27, twiddle_gen="rom"),
    dict(n=4096, rounding="round", bypass_fly=True, twiddle_width=18),
    dict(n=65536, mode="unscaled", data_width=24, twiddle_gen="taylor_new")],
    ids=["default", "n8", "wide", "round18", "taylor_new"])
def test_fftconfig_properties_and_roundtrip(kw):
    j, p = _both(kw)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    for name in ("stages", "scale", "output_width", "twiddle_magnitude",
                 "twiddle_shift"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.describe() == j.describe()
    for s in range(j.stages):
        assert p.stage_input_width(s) == j.stage_input_width(s)
        for inverse in (False, True):
            assert p.stage_twiddle_order(s, inverse) == j.stage_twiddle_order(
                s, inverse)
    got = config_from_jax(j)
    assert type(got) is pc.FFTConfig and got == p
    assert config_from_jax(p) is p
    assert jc.FFTConfig(**dataclasses.asdict(got)) == j       # and back
    for mode in ("UNSCALED", "TRUNCATE", "ROUNDING"):
        assert dataclasses.asdict(pc.FFTConfig.from_reference_mode(
            64, mode)) == dataclasses.asdict(jc.FFTConfig.from_reference_mode(
                64, mode))


def test_config_from_jax_rejects_other_fields():
    @dataclasses.dataclass
    class Other:
        n: int = 8

    with pytest.raises(TypeError, match="fields"):
        config_from_jax(Other())


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted((ROOT / "intfftk_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    """No import of jax or of the JAX package, at any depth of the file."""
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "intfftk_tpu"), (path, name)


def test_port_imports_neither_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import intfftk_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'intfftk_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'intfftk_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if "
        "m.startswith('intfftk_tpu_torch')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    walked = set(res.stdout.split())
    assert len(walked) >= 30
    assert {f"intfftk_tpu_torch.{m}" for m in (
        "parallel.mesh", "parallel.multihost", "parallel.four_step",
        "utils.dat_io", "utils.lanes", "runtime.native", "entry",
        "examples.fft_single", "examples.fft_ifft_pair")} <= walked
