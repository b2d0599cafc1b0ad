"""The port's large-n slices (intfftk_tpu_torch.ops.fused_fft) against the
JAX Pallas kernels in interpret mode and golden four_step_int (four-step
schedule) or fft_int (monolithic schedule), exactly.

On the CPU ``fused_pass`` runs its plain version; the CUDA kernel is held
against that same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int
from intfftk_tpu.golden.four_step import four_step_int
from intfftk_tpu.ops import pallas_fft as jp
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.convert import tables_from_jax
from intfftk_tpu_torch.device import use_kernel
from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan, circle_table,
                                              fused_pass,
                                              fused_pass_reference)
from intfftk_tpu_torch.ops.transform import pack_tables

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]
REPO = Path(__file__).resolve().parent.parent


def _random(shape, w=16, seed=0):
    rng = np.random.default_rng(seed)
    lim = 1 << (w - 1)
    return rng.integers(-lim, lim, shape), rng.integers(-lim, lim, shape)


def _adversarial(shape, w=16):
    """Full-scale pattern that drives the round-mode difference to
    +2^(w-1) (tests/test_pallas.py::_adversarial)."""
    rng = np.random.default_rng(99)
    xr = np.full(shape, -(1 << (w - 1)), np.int64)
    xr[..., ::3] = (1 << (w - 1)) - 1
    return xr, rng.integers(-(1 << (w - 1)), 1 << (w - 1), shape)


@functools.cache
def _jax_plan(cfg, n1, n2, inverse=False, order="natural"):
    return jp.LargeFFTPlan(cfg, n1, n2, inverse=inverse, order=order,
                           interpret=True)


def _port_blocks(plan, xr, xi):
    """Run the port's block contract on flat [B, n] numpy input and return
    the flat natural spectrum as int64 numpy."""
    nb = xr.shape[0]
    blk = lambda x: torch.as_tensor(x).to(plan.in_dtype).reshape(
        (nb,) + plan.block_in_shape).contiguous()
    yr, yi = plan.apply_blocks(blk(xr), blk(xi))
    assert yr.dtype == plan.out_dtype
    assert tuple(yr.shape) == (nb,) + plan.block_out_shape
    return (yr.reshape(nb, -1).numpy().astype(np.int64),
            yi.reshape(nb, -1).numpy().astype(np.int64))


def _check_slice(cfg, n1, n2, xr, xi):
    plan = LargeFFTPlan(P(cfg), n1, n2, device="cpu")
    jplan = _jax_plan(cfg, n1, n2)
    assert (plan.n1, plan.n2, plan.io16) == (jplan.n1, jplan.n2, jplan.io16)
    yr, yi = _port_blocks(plan, xr, xi)
    gr, gi = four_step_int(xr, xi, cfg, plan.n1, plan.n2)
    np.testing.assert_array_equal(yr, gr)
    np.testing.assert_array_equal(yi, gi)
    jr, ji = jplan(xr, xi)
    np.testing.assert_array_equal(yr, np.asarray(jr, np.int64))
    np.testing.assert_array_equal(yi, np.asarray(ji, np.int64))


# ----------------------------------------------------------- one pass

FORMS = [(False, True, False), (False, False, False), (True, True, False),
         (True, False, False), (False, True, True), (True, False, True)]


@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("epi", [True, False], ids=["epi_turn", "plain"])
@pytest.mark.parametrize("inverse,natural,turned", FORMS, ids=[
    "fwd_nat", "fwd_raw", "inv_nat", "inv_raw", "fwd_nat_turned_in",
    "inv_raw_turned_in"])
def test_fused_pass_vs_jax(mode, rounding, epi, inverse, natural, turned):
    """fused_pass_reference == JAX _FusedPass (interpret) at R=64, C=16,
    B=3, in every narrow form: forward and inverse, natural and raw order,
    rows read straight or turned, with and without the epilogue and
    transposed store; full-scale adversarial items.  The wrapper takes
    the same plain version on the CPU and counts no launch."""
    r, c, nb = 64, 16, 3
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    shape = (nb, c, r) if turned else (nb, r, c)
    xr, xi = _random(shape, seed=1)
    xr[0], xi[0] = _adversarial(shape[1:])
    xi[2], xr[2] = _adversarial(shape[1:])
    jpass = jp._FusedPass(cfg, inverse, wide_in=False, wide_out=False,
                          has_epi=epi, transpose_out=epi,
                          transpose_in=turned, interpret=True,
                          spectrum_rows="natural" if natural else "bitrev")
    tables = tuple(torch.as_tensor(t) for t in pack_tables(P(cfg)))
    for ours, theirs in zip(tables, (jpass.consts["w_re"],
                                     jpass.consts["w_im"])):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs)[:, 0])
    e = (tuple(torch.as_tensor(t) for t in circle_table(
        P(dataclasses.replace(cfg, n=r * c)), r, c, inverse,
        "natural" if natural else "raw")) if epi else None)
    (jr,), (ji,) = jpass.apply(
        jpass.consts, (jnp.asarray(xr, jnp.int32),),
        (jnp.asarray(xi, jnp.int32),),
        epi=tuple(jnp.asarray(t.numpy()) for t in e) if epi else None)
    x = [torch.as_tensor(v).int() for v in (xr, xi)]
    kw = dict(epi=e, transpose_out=epi, inverse=inverse, natural=natural,
              transpose_in=turned)
    yr, yi = fused_pass_reference(*x, P(cfg), tables, **kw)
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji))
    before = fused_pass.launches
    wr, wi = fused_pass(*x, P(cfg), tables, **kw)
    assert torch.equal(wr, yr) and torch.equal(wi, yi)
    assert fused_pass.launches == before


def test_fused_pass_rejects():
    cfg = FFTConfig(n=64)
    tables = tuple(torch.as_tensor(t) for t in pack_tables(P(cfg)))
    x = torch.zeros(2, 64, 8, dtype=torch.int32)
    with pytest.raises(TypeError):           # int64 -> int32 is no pass
        fused_pass(x.long(), x.long(), P(cfg), tables, transpose_out=False,
                   out_dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_pass(x[:, :32], x[:, :32], P(cfg), tables, transpose_out=False)
    with pytest.raises(ValueError):
        fused_pass(x.transpose(1, 2), x.transpose(1, 2), P(cfg), tables,
                   transpose_out=False)
    with pytest.raises(ValueError):          # unscaled 64 rows: 22 bits
        fused_pass(x.short(), x.short(), P(dataclasses.replace(
            cfg, mode="unscaled")), tables, transpose_out=False)
    with pytest.raises(ValueError):          # epilogue table of wrong shape
        fused_pass(x, x, P(cfg), tables, epi=(tables[0], tables[1]),
                   transpose_out=True)
    with pytest.raises(ValueError):          # a turned load wants [B, C, R]
        fused_pass(x, x, P(cfg), tables, transpose_out=False, transpose_in=True)


def test_device_resolver():
    assert use_kernel("cpu") is False
    with pytest.raises(RuntimeError):
        use_kernel("meta")


# --------------------------------------------------------- the slice

@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("split", [None, (16, 256)], ids=["32x128", "16x256"])
@pytest.mark.parametrize("batch", [1, 3])
def test_large_fft_4096(mode, rounding, split, batch):
    """n = 4096, the default 32x128 split and 16x256, random and
    full-scale adversarial stimuli."""
    cfg = FFTConfig(n=4096, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    n1, n2 = split or (None, None)
    _check_slice(cfg, n1, n2, *_random((batch, 4096), seed=batch))
    _check_slice(cfg, n1, n2, *_adversarial((batch, 4096)))


def test_large_fft_64k_main_path():
    """The slice at full size: 64k scaled/round 16/16, apply_blocks on
    int16 [2, 256, 256]; item 0 random, item 1 full-scale adversarial."""
    cfg = FFTConfig(n=65536, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    xr, xi = _random((2, 65536), seed=7)
    xr[1], xi[1] = _adversarial((65536,))
    plan = LargeFFTPlan(P(cfg), device="cpu")
    assert (plan.n1, plan.n2, plan.io16) == (256, 256, True)
    _check_slice(cfg, None, None, xr, xi)


def _raw_golden(xr, xi, cfg, plan):
    """Golden bits of a raw-order plan on flat [B, n] input in its own
    layout (raw spectrum in for the inverse, out for the forward)."""
    o = plan.raw_spectrum_order()
    if plan.inverse:
        nr, ni = np.empty_like(xr), np.empty_like(xi)
        nr[:, o], ni[:, o] = xr, xi
        return four_step_int(nr, ni, cfg, plan.n1, plan.n2, inverse=True)
    gr, gi = four_step_int(xr, xi, cfg, plan.n1, plan.n2)
    return gr[:, o], gi[:, o]


@pytest.mark.parametrize("inverse,order", [(True, "natural"),
                                           (False, "raw"), (True, "raw")],
                         ids=["inv", "fwd_raw", "inv_raw"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_large_fft_4096_inverse_raw(mode, rounding, inverse, order):
    """n = 4096, 32x128: the inverse and raw-order plans == the JAX plans
    (interpret) == golden four_step_int, random and full-scale
    adversarial stimuli."""
    cfg = FFTConfig(n=4096, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    plan = LargeFFTPlan(P(cfg), inverse=inverse, order=order, device="cpu")
    jplan = _jax_plan(cfg, None, None, inverse, order)
    assert (plan.n1, plan.n2, plan.io16) == (jplan.n1, jplan.n2, jplan.io16)
    np.testing.assert_array_equal(plan.raw_spectrum_order(),
                                  jplan.raw_spectrum_order())
    xr, xi = _random((2, 4096), seed=9)
    xr[1], xi[1] = _adversarial((4096,))
    yr, yi = _port_blocks(plan, xr, xi)
    jr, ji = jplan(xr, xi)
    np.testing.assert_array_equal(yr, np.asarray(jr, np.int64))
    np.testing.assert_array_equal(yi, np.asarray(ji, np.int64))
    if order == "natural":
        gr, gi = four_step_int(xr, xi, cfg, plan.n1, plan.n2, inverse=True)
    else:
        gr, gi = _raw_golden(xr, xi, cfg, plan)
    np.testing.assert_array_equal(yr, gr)
    np.testing.assert_array_equal(yi, gi)


@pytest.mark.parametrize("mode,rounding", MODES)
def test_large_fft_raw_chain(mode, rounding):
    """A raw forward's output block is the swapped-factor raw inverse's
    input block: fwd -> inv with no reorder == the natural golden
    composition (icfg widened as the pair widens it; the unscaled
    forward's 28-bit spectrum goes into a scaled/round inverse)."""
    cfg = FFTConfig(n=4096, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    if mode == "unscaled":
        icfg = dataclasses.replace(icfg, mode="scaled", rounding="round")
    fwd = LargeFFTPlan(P(cfg), order="raw", device="cpu")
    inv = LargeFFTPlan(P(icfg), fwd.n2, fwd.n1, inverse=True, order="raw", device="cpu")
    assert inv.block_in_shape == fwd.block_out_shape
    assert inv.block_out_shape == fwd.block_in_shape
    np.testing.assert_array_equal(inv.raw_spectrum_order(),
                                  fwd.raw_spectrum_order())
    xr, xi = _adversarial((2, 4096))
    yr, yi = _port_blocks(fwd, xr, xi)
    zr, zi = _port_blocks(inv, yr, yi)
    gr, gi = four_step_int(xr, xi, cfg, fwd.n1, fwd.n2)
    hr, hi = four_step_int(gr, gi, icfg, inv.n1, inv.n2, inverse=True)
    np.testing.assert_array_equal(zr, hr)
    np.testing.assert_array_equal(zi, hi)


def test_large_fft_64k_roundtrip():
    """The 64k raw-chained roundtrip of the chip run at batch 1, 16-bit
    scaled/round, against golden: both halves bit-equal."""
    cfg = FFTConfig(n=65536, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    fwd = LargeFFTPlan(P(cfg), order="raw", device="cpu")
    inv = LargeFFTPlan(P(icfg), fwd.n2, fwd.n1, inverse=True, order="raw", device="cpu")
    xr, xi = _random((1, 65536), seed=10)
    yr, yi = _port_blocks(fwd, xr, xi)
    gr, gi = four_step_int(xr, xi, cfg, 256, 256)
    o = fwd.raw_spectrum_order()
    np.testing.assert_array_equal(yr, gr[:, o])
    np.testing.assert_array_equal(yi, gi[:, o])
    zr, zi = _port_blocks(inv, yr, yi)
    hr, hi = four_step_int(gr, gi, icfg, 256, 256, inverse=True)
    np.testing.assert_array_equal(zr, hr)
    np.testing.assert_array_equal(zi, hi)


def test_forward_flat():
    cfg = FFTConfig(n=4096, mode="scaled", rounding="truncate")
    xr, xi = _random((2, 4096), seed=3)
    yr, yi = LargeFFTPlan(P(cfg), device="cpu")(torch.as_tensor(xr), torch.as_tensor(xi))
    gr, gi = four_step_int(xr, xi, cfg, 32, 128)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)


def test_bypass_fly():
    cfg = FFTConfig(n=4096, bypass_fly=True)
    _check_slice(cfg, None, None, *_random((2, 4096), seed=4))


@pytest.mark.parametrize("inverse,order", [(False, "natural"),
                                           (True, "natural"), (False, "raw"),
                                           (True, "raw")],
                         ids=["fwd", "inv", "fwd_raw", "inv_raw"])
def test_tables_from_jax(inverse, order):
    """The port's own tables equal the converted JAX consts, and a plan
    loaded with the JAX tables gives the same bits."""
    cfg = FFTConfig(n=4096, mode="scaled", rounding="round")
    jplan = _jax_plan(cfg, None, None, inverse, order)
    tables = tables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jplan.consts))
    plan = LargeFFTPlan(P(cfg), inverse=inverse, order=order, device="cpu")
    for name, t in tables.items():
        assert torch.equal(getattr(plan, name), t), name
    loaded = LargeFFTPlan(P(cfg), inverse=inverse, order=order, device="cpu")
    for name in tables:
        getattr(loaded, name).zero_()
    loaded.load_tables(tables)
    xr, xi = _adversarial((2, 4096))
    for a, b in zip(_port_blocks(plan, xr, xi),
                    _port_blocks(loaded, xr, xi)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        loaded.load_tables({"er": tables["w1r"]})


@pytest.mark.parametrize("kw", [
    dict(cfg=FFTConfig(n=65536, mode="unscaled", data_width=20))],
    ids=["wide"])
def test_not_ported_raises(kw):
    """A wide four-step plan is built (here pass 2 widens: 20 -> 28 -> 36
    bits, int32 -> int32 -> int64 blocks); the monolithic schedule keeps
    refusing a wide data path, as the JAX one does."""
    cfg = kw.pop("cfg", FFTConfig(n=65536))
    plan = LargeFFTPlan(P(cfg), **kw, device="cpu")
    assert (plan.wide_in, plan.wide1, plan.wide2) == (False, False, True)
    assert (plan.in_dtype, plan.mid_dtype, plan.out_dtype) == (
        torch.int32, torch.int32, torch.int64)
    assert [kw["out_dtype"] for _, kw in plan.passes()] == [torch.int32,
                                                            torch.int64]
    with pytest.raises(NotImplementedError, match="monolithic"):
        LargeFFTPlan(P(cfg), schedule="monolithic", **kw, device="cpu")


def test_bad_arguments():
    with pytest.raises(ValueError):
        LargeFFTPlan(P(FFTConfig(n=4096)), 4, 1024, device="cpu")
    with pytest.raises(ValueError):
        LargeFFTPlan(P(FFTConfig(n=4096)), order="bitrev", device="cpu")


def test_import_leaves_jax_out():
    """The port never imports JAX (a subprocess: conftest imports it)."""
    code = ("import sys, intfftk_tpu_torch, intfftk_tpu_torch.ops, "
            "intfftk_tpu_torch.ops.single_pass, "
            "intfftk_tpu_torch.ops.twiddle_synth, intfftk_tpu_torch.parallel, "
            "intfftk_tpu_torch.runtime, intfftk_tpu_torch.convert, "
            "intfftk_tpu_torch.device; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'intfftk_tpu.ops', "
            "'intfftk_tpu.parallel', 'intfftk_tpu.runtime'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ----------------------------------------------------- monolithic schedule

@functools.cache
def _jax_mono(cfg, inverse=False, order="natural"):
    return jp.LargeFFTPlan(cfg, inverse=inverse, order=order,
                           interpret=True, schedule="monolithic")


def _mono_golden(xr, xi, cfg, plan):
    """Golden fft_int bits of a monolithic plan on flat [B, n] input in its
    own layout (raw spectrum in for the inverse, out for the forward)."""
    if plan.order == "natural":
        return fft_int(xr, xi, cfg, inverse=plan.inverse)
    o = plan.raw_spectrum_order()
    if plan.inverse:
        nr, ni = np.empty_like(xr), np.empty_like(xi)
        nr[:, o], ni[:, o] = xr, xi
        return fft_int(nr, ni, cfg, inverse=True)
    gr, gi = fft_int(xr, xi, cfg)
    return gr[:, o], gi[:, o]


def _check_mono(cfg, xr, xi, inverse=False, order="natural", jax=True):
    """The monolithic plan's blocks == golden fft_int (== the JAX plan)."""
    plan = LargeFFTPlan(P(cfg), inverse=inverse, order=order,
                        schedule="monolithic", device="cpu")
    assert plan.epi_mode is None
    yr, yi = _port_blocks(plan, xr, xi)
    gr, gi = _mono_golden(xr, xi, cfg, plan)
    np.testing.assert_array_equal(yr, gr)
    np.testing.assert_array_equal(yi, gi)
    if jax:
        jplan = _jax_mono(cfg, inverse, order)
        assert (plan.n1, plan.n2, plan.io16) == (jplan.n1, jplan.n2,
                                                 jplan.io16)
        assert plan.block_in_shape == jplan.block_in_shape
        assert plan.block_out_shape == jplan.block_out_shape
        jr, ji = jplan(xr, xi)
        np.testing.assert_array_equal(yr, np.asarray(jr, np.int64))
        np.testing.assert_array_equal(yi, np.asarray(ji, np.int64))
    return plan, (yr, yi)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_monolithic_modes(mode, rounding, inverse):
    """n = 1024 (8 x 128) in every mode and both directions == fft_int ==
    the JAX monolithic plan (tests/test_pallas.py:227-262)."""
    dw = 12 if mode == "unscaled" else 14
    cfg = FFTConfig(n=1 << 10, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=16)
    xr, xi = _random((2, 1 << 10), w=dw - 1, seed=21)
    plan, _ = _check_mono(cfg, xr, xi, inverse)
    assert (plan.n1, plan.n2) == (8, 128)


@pytest.mark.parametrize("adversarial", [False, True],
                         ids=["random", "fullscale"])
def test_monolithic_taylor_8k(adversarial):
    """8k (64 x 128): top stage order 12 >= TAYLOR_STAGE, so the 2-D
    tables hold Taylor-generated twiddles; the full-scale case is the
    round-mode register wrap through the 2-D stages
    (tests/test_pallas.py:265, :419)."""
    cfg = FFTConfig(n=1 << 13, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    xr, xi = (_adversarial((2, 1 << 13)) if adversarial
              else _random((1, 1 << 13), seed=23))
    _check_mono(cfg, xr, xi)


def test_monolithic_roundtrip():
    """Forward then inverse through the monolithic plans == the golden
    monolithic roundtrip (tests/test_pallas.py:245-262)."""
    cfg = FFTConfig(n=1 << 10, mode="scaled", rounding="round",
                    data_width=14, twiddle_width=16)
    xr, xi = _random((2, 1 << 10), w=13, seed=22)
    _, (fr, fi) = _check_mono(cfg, xr, xi)
    _, (rr, ri) = _check_mono(cfg, fr, fi, inverse=True)
    hr, hi = fft_int(*fft_int(xr, xi, cfg), cfg, inverse=True)
    np.testing.assert_array_equal(rr, hr)
    np.testing.assert_array_equal(ri, hi)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_monolithic_raw(inverse):
    """order="raw" at 8k (64 x 128, n1 != n2): no reorder; the forward's
    raw layout is the JAX one, and the inverse consumes exactly the
    forward's raw layout, bit-equal to the JAX kernel on the same input.
    The JAX plan's raw_spectrum_order() for the monolithic inverse does
    not describe its own kernel when n1 != n2 (ROADMAP §C)."""
    cfg = FFTConfig(n=1 << 13, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    xr, xi = _random((2, 1 << 13), seed=24)
    plan, _ = _check_mono(cfg, xr, xi, inverse, "raw")
    fwd = LargeFFTPlan(P(cfg), order="raw", schedule="monolithic", device="cpu")
    np.testing.assert_array_equal(plan.raw_spectrum_order(),
                                  fwd.raw_spectrum_order())
    np.testing.assert_array_equal(fwd.raw_spectrum_order(),
                                  _jax_mono(cfg, False,
                                            "raw").raw_spectrum_order())


def test_monolithic_raw_chain():
    """A raw monolithic forward's output blocks are the raw monolithic
    inverse's input blocks (same factors): fwd -> inv with no reorder ==
    the golden natural composition."""
    cfg = FFTConfig(n=1 << 13, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    fwd = LargeFFTPlan(P(cfg), order="raw", schedule="monolithic", device="cpu")
    inv = LargeFFTPlan(P(cfg), inverse=True, order="raw", schedule="monolithic", device="cpu")
    assert inv.block_in_shape == fwd.block_out_shape
    xr, xi = _adversarial((2, 1 << 13))
    zr, zi = _port_blocks(inv, *_port_blocks(fwd, xr, xi))
    hr, hi = fft_int(*fft_int(xr, xi, cfg), cfg, inverse=True)
    np.testing.assert_array_equal(zr, hr)
    np.testing.assert_array_equal(zi, hi)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_monolithic_64k(inverse):
    """The port's monolithic plan at 64k (256 x 256), batch 1, int16
    blocks, against fft_int; the flat entry point gives the same bits."""
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    xr, xi = _random((1, 1 << 16), seed=25)
    xr[0, ::5] = -(1 << 15)
    plan, (yr, yi) = _check_mono(cfg, xr, xi, inverse, jax=False)
    assert (plan.n1, plan.n2, plan.in_dtype) == (256, 256, torch.int16)
    fr, fi = plan(torch.as_tensor(xr), torch.as_tensor(xi))
    np.testing.assert_array_equal(fr.numpy(), yr)
    np.testing.assert_array_equal(fi.numpy(), yi)


def test_monolithic_limits():
    """The monolithic schedule reaches 512K, the reference core's limit;
    above it, ValueError.  bypass_fly leaves the reorders alone."""
    p = LargeFFTPlan(P(FFTConfig(n=1 << 19)), schedule="monolithic", device="cpu")
    assert (p.n1, p.n2, tuple(p.t2r.shape)) == (1024, 512, (1024, 512))
    with pytest.raises(ValueError, match="fourstep"):
        LargeFFTPlan(P(FFTConfig(n=1 << 20)), schedule="monolithic", device="cpu")
    with pytest.raises(ValueError):
        LargeFFTPlan(P(FFTConfig(n=1 << 10)), schedule="whole", device="cpu")
    cfg = FFTConfig(n=1 << 10, bypass_fly=True)
    xr, xi = _random((1, 1 << 10), seed=26)
    for inverse in (False, True):
        _check_mono(cfg, xr, xi, inverse, jax=False)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_tables_from_jax_monolithic(inverse):
    """The JAX monolithic consts (wsr/wsi, the 2-D tables as er/ei, mrev)
    convert to the port's wsr, wsi, t2r, t2i; mrev is dropped, and a plan
    loaded with them gives the same bits."""
    cfg = FFTConfig(n=1 << 13, mode="scaled", rounding="round")
    jplan = _jax_mono(cfg, inverse)
    tables = tables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jplan.consts))
    assert set(tables) == {"wsr", "wsi", "t2r", "t2i"}
    plan = LargeFFTPlan(P(cfg), inverse=inverse, schedule="monolithic", device="cpu")
    for name, t in tables.items():
        assert torch.equal(getattr(plan, name), t), name
    loaded = LargeFFTPlan(P(cfg), inverse=inverse, schedule="monolithic", device="cpu")
    for name in tables:
        getattr(loaded, name).zero_()
    loaded.load_tables(tables)
    xr, xi = _adversarial((1, 1 << 13))
    for a, b in zip(_port_blocks(plan, xr, xi),
                    _port_blocks(loaded, xr, xi)):
        np.testing.assert_array_equal(a, b)
