"""The port's four-step slice (intfftk_tpu_torch.ops.fused_fft) against the
JAX Pallas kernels in interpret mode and golden four_step_int, exactly.

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
from intfftk_tpu.golden.four_step import four_step_int
from intfftk_tpu.ops import pallas_fft as jp
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
def _jax_plan(cfg, n1, n2):
    return jp.LargeFFTPlan(cfg, n1, n2, interpret=True)


def _port_blocks(plan, xr, xi):
    """Run the port's block contract on flat [B, n] numpy input and return
    the flat natural spectrum as int64 numpy."""
    nb = xr.shape[0]
    blk = lambda x: torch.as_tensor(x).to(plan.io_dtype).reshape(
        (nb,) + plan.block_in_shape).contiguous()
    yr, yi = plan.apply_blocks(blk(xr), blk(xi))
    assert yr.dtype == plan.io_dtype
    assert tuple(yr.shape) == (nb,) + plan.block_out_shape
    return (yr.reshape(nb, -1).numpy().astype(np.int64),
            yi.reshape(nb, -1).numpy().astype(np.int64))


def _check_slice(cfg, n1, n2, xr, xi):
    plan = LargeFFTPlan(cfg, n1, n2)
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

@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("epi", [True, False], ids=["epi_turn", "plain"])
def test_fused_pass_vs_jax(mode, rounding, epi):
    """fused_pass_reference == JAX _FusedPass (interpret) at R=64, C=16,
    B=3, in the epilogue + transposed-store form and the plain form."""
    r, c, nb = 64, 16, 3
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    xr, xi = _random((nb, r, c), seed=1)
    xr[0], xi[0] = _adversarial((r, c))
    jpass = jp._FusedPass(cfg, False, wide_in=False, wide_out=False,
                          has_epi=epi, transpose_out=epi, interpret=True,
                          spectrum_rows="natural")
    tables = tuple(torch.as_tensor(t) for t in pack_tables(cfg))
    for ours, theirs in zip(tables, (jpass.consts["w_re"],
                                     jpass.consts["w_im"])):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs)[:, 0])
    e = (tuple(torch.as_tensor(t) for t in circle_table(
        dataclasses.replace(cfg, n=r * c), r, c)) if epi else None)
    (jr,), (ji,) = jpass.apply(
        jpass.consts, (jnp.asarray(xr, jnp.int32),),
        (jnp.asarray(xi, jnp.int32),),
        epi=tuple(jnp.asarray(t.numpy()) for t in e) if epi else None)
    x = [torch.as_tensor(v).int() for v in (xr, xi)]
    yr, yi = fused_pass_reference(*x, cfg, tables, epi=e, transpose_out=epi)
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji))
    # the wrapper takes the plain version for CPU tensors, and counts
    # no launch
    before = fused_pass.launches
    wr, wi = fused_pass(*x, cfg, tables, epi=e, transpose_out=epi)
    assert torch.equal(wr, yr) and torch.equal(wi, yi)
    assert fused_pass.launches == before


def test_fused_pass_rejects():
    cfg = FFTConfig(n=64)
    tables = tuple(torch.as_tensor(t) for t in pack_tables(cfg))
    x = torch.zeros(2, 64, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        fused_pass(x.long(), x.long(), cfg, tables, transpose_out=False)
    with pytest.raises(ValueError):
        fused_pass(x[:, :32], x[:, :32], cfg, tables, transpose_out=False)
    with pytest.raises(ValueError):
        fused_pass(x.transpose(1, 2), x.transpose(1, 2), cfg, tables,
                   transpose_out=False)
    with pytest.raises(ValueError):          # unscaled 64 rows: 22 bits
        fused_pass(x.short(), x.short(), dataclasses.replace(
            cfg, mode="unscaled"), tables, transpose_out=False)
    with pytest.raises(ValueError):          # epilogue table of wrong shape
        fused_pass(x, x, cfg, tables, epi=(tables[0], tables[1]),
                   transpose_out=True)


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
    plan = LargeFFTPlan(cfg)
    assert (plan.n1, plan.n2, plan.io16) == (256, 256, True)
    _check_slice(cfg, None, None, xr, xi)


def test_forward_flat():
    cfg = FFTConfig(n=4096, mode="scaled", rounding="truncate")
    xr, xi = _random((2, 4096), seed=3)
    yr, yi = LargeFFTPlan(cfg)(torch.as_tensor(xr), torch.as_tensor(xi))
    gr, gi = four_step_int(xr, xi, cfg, 32, 128)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)


def test_bypass_fly():
    cfg = FFTConfig(n=4096, bypass_fly=True)
    _check_slice(cfg, None, None, *_random((2, 4096), seed=4))


def test_tables_from_jax():
    """The port's own tables equal the converted JAX consts, and a plan
    loaded with the JAX tables gives the same bits."""
    cfg = FFTConfig(n=4096, mode="scaled", rounding="round")
    jplan = _jax_plan(cfg, None, None)
    tables = tables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jplan.consts))
    plan = LargeFFTPlan(cfg)
    for name, t in tables.items():
        assert torch.equal(getattr(plan, name), t), name
    loaded = LargeFFTPlan(cfg)
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
    dict(inverse=True), dict(order="raw"), dict(schedule="monolithic"),
    dict(epi_synth=True), dict(cfg=FFTConfig(n=65536, mode="unscaled",
                                             data_width=20))],
    ids=["inverse", "raw", "monolithic", "epi_synth", "wide"])
def test_not_ported_raises(kw):
    cfg = kw.pop("cfg", FFTConfig(n=65536))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LargeFFTPlan(cfg, **kw)


def test_bad_arguments():
    with pytest.raises(ValueError):
        LargeFFTPlan(FFTConfig(n=4096), 4, 1024)
    with pytest.raises(ValueError):
        LargeFFTPlan(FFTConfig(n=4096), order="bitrev")


def test_import_leaves_jax_out():
    """The port never imports JAX (a subprocess: conftest imports it)."""
    code = ("import sys, intfftk_tpu_torch, intfftk_tpu_torch.ops, "
            "intfftk_tpu_torch.convert, intfftk_tpu_torch.device; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'intfftk_tpu.ops', "
            "'intfftk_tpu.parallel', 'intfftk_tpu.runtime'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
