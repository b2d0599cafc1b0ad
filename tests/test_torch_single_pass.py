"""The port's single-pass engines (intfftk_tpu_torch.ops.single_pass:
PallasFFTPlan, FusedAxisFFT) against the JAX Pallas plans in interpret mode
and golden fft_int, exactly, in both directions, layouts and orders.

On the CPU the engines run the kernel's plain version; the CUDA kernel is
held against that same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden import fft_int
from intfftk_tpu.golden.float_model import bitrev_indices
from intfftk_tpu.ops import pallas_fft as jp
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.convert import tables_from_jax
from intfftk_tpu_torch.ops.fused_fft import fused_pass
from intfftk_tpu_torch.ops.single_pass import FusedAxisFFT, PallasFFTPlan

MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]
ORDERS = ["natural", "bitrev"]


def _stimulus(shape, seed, w=16):
    """Random w-bit [..., n] data; the first transform is the full-scale
    pattern that drives the round-mode difference to +2^(w-1), the last
    has the most-negative value everywhere in its imaginary part."""
    rng = np.random.default_rng(seed)
    lim = 1 << (w - 1)
    xr = rng.integers(-lim, lim, shape)
    xi = rng.integers(-lim, lim, shape)
    xr.reshape(-1, shape[-1])[0] = -lim
    xr.reshape(-1, shape[-1])[0, ::3] = lim - 1
    xi.reshape(-1, shape[-1])[-1] = -lim
    return xr, xi


def _golden(xr, xi, cfg, inverse, order):
    """fft_int along the last axis; "bitrev" is the raw core contract: the
    forward's spectrum comes out bit-reversed, the inverse's goes in so."""
    rev = bitrev_indices(cfg.n)
    if order == "bitrev" and inverse:
        xr, xi = xr[..., rev], xi[..., rev]
    gr, gi = fft_int(xr, xi, cfg, inverse=inverse)
    if order == "bitrev" and not inverse:
        gr, gi = gr[..., rev], gi[..., rev]
    return gr, gi


def _run(plan, xr, xi):
    before = fused_pass.launches
    yr, yi = plan(torch.as_tensor(xr), torch.as_tensor(xi))
    assert fused_pass.launches == before      # the CPU runs no kernel
    assert yr.dtype == torch.int32 and yr.shape == xr.shape
    return yr.numpy().astype(np.int64), yi.numpy().astype(np.int64)


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.int64))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("layout", ["nb", "bn"])
@pytest.mark.parametrize("mode,rounding", MODES)
def test_pallas_plan_vs_jax(mode, rounding, layout, inverse, order):
    """n = 64, B = 128 (the JAX plan's lane granule) == JAX PallasFFTPlan
    (interpret) == golden."""
    n, b = 64, 128
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    xr, xi = _stimulus((b, n), seed=n)
    gr, gi = _golden(xr, xi, cfg, inverse, order)
    if layout == "nb":
        xr, xi, gr, gi = xr.T, xi.T, gr.T, gi.T
    plan = PallasFFTPlan(P(cfg), inverse=inverse, layout=layout, order=order, device="cpu")
    got = _run(plan, xr, xi)
    jplan = jp.PallasFFTPlan(cfg, inverse=inverse, layout=layout,
                             order=order, interpret=True)
    _equal(got, jplan(xr, xi))
    _equal(got, (gr, gi))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("layout", ["nb", "bn"])
def test_pallas_plan_ragged_batch(layout, inverse, order):
    """Any B >= 1: B = 5 and B = 200 (not a multiple of the kernel's
    32-column tile), n = 256, scaled/round, against golden."""
    cfg = FFTConfig(n=256, mode="scaled", rounding="round")
    plan = PallasFFTPlan(P(cfg), inverse=inverse, layout=layout, order=order, device="cpu")
    for b in (5, 200):
        xr, xi = _stimulus((b, 256), seed=b)
        gr, gi = _golden(xr, xi, cfg, inverse, order)
        if layout == "nb":
            xr, xi, gr, gi = xr.T, xi.T, gr.T, gi.T
        _equal(_run(plan, xr, xi), (gr, gi))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_pallas_plan_int32_unscaled(inverse, order):
    """n = 1024 unscaled/truncate: a 26-bit data path from 16-bit data,
    B = 3, against golden."""
    cfg = FFTConfig(n=1024, mode="unscaled", rounding="truncate")
    plan = PallasFFTPlan(P(cfg), inverse=inverse, layout="nb", order=order, device="cpu")
    xr, xi = _stimulus((3, 1024), seed=11)
    gr, gi = _golden(xr, xi, cfg, inverse, order)
    _equal(_run(plan, xr.T, xi.T), (gr.T, gi.T))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_fused_axis_vs_jax(inverse, order):
    """[2, 3, n] along the last axis, n = 1024, scaled/truncate == JAX
    FusedAxisFFT (interpret) == golden."""
    cfg = FFTConfig(n=1024, mode="scaled", rounding="truncate")
    xr, xi = _stimulus((2, 3, 1024), seed=12)
    got = _run(FusedAxisFFT(P(cfg), inverse=inverse, order=order, device="cpu"), xr, xi)
    _equal(got, jp.FusedAxisFFT(cfg, inverse=inverse, order=order,
                                interpret=True)(xr, xi))
    _equal(got, _golden(xr, xi, cfg, inverse, order))


def test_fused_axis_4096():
    """The channelizer's size, n = 4096 scaled/round, inverse, 2
    transforms: == JAX FusedAxisFFT (interpret) == golden."""
    cfg = FFTConfig(n=4096, mode="scaled", rounding="round")
    xr, xi = _stimulus((2, 4096), seed=13)
    got = _run(FusedAxisFFT(P(cfg), inverse=True, device="cpu"), xr, xi)
    _equal(got, jp.FusedAxisFFT(cfg, inverse=True, interpret=True)(xr, xi))
    _equal(got, fft_int(xr, xi, cfg, inverse=True))


@pytest.mark.parametrize("cls", ["PallasFFTPlan", "FusedAxisFFT"])
def test_tables_from_jax(cls):
    """The JAX plan's consts convert onto the port's buffers and equal the
    port's own tables; a plan loaded with them gives the same bits."""
    cfg = FFTConfig(n=512, twiddle_width=18)
    jax_cls, port_cls = getattr(jp, cls), globals()[cls]
    jplan = jax_cls(cfg, inverse=True, interpret=True)
    tables = tables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jplan.consts))
    plan = port_cls(P(cfg), inverse=True, device="cpu")
    for name, t in tables.items():
        assert torch.equal(getattr(plan, name), t), name
    loaded = port_cls(P(cfg), inverse=True, device="cpu")
    loaded.w_re.zero_()
    loaded.load_state_dict(tables)
    xr, xi = _stimulus((4, 512), seed=14)
    x = (xr.T, xi.T) if cls == "PallasFFTPlan" else (xr, xi)
    _equal(_run(loaded, *x), _run(plan, *x))


def test_guards():
    with pytest.raises(NotImplementedError):
        PallasFFTPlan(P(FFTConfig(n=8192)), device="cpu")
    with pytest.raises(NotImplementedError, match="PallasWideFFTPlan"):
        FusedAxisFFT(P(FFTConfig(n=4096, mode="unscaled", data_width=24)), device="cpu")
    with pytest.raises(ValueError):
        PallasFFTPlan(P(FFTConfig(n=64)), layout="cn", device="cpu")
    with pytest.raises(ValueError):
        FusedAxisFFT(P(FFTConfig(n=64)), order="raw", device="cpu")
    plan = PallasFFTPlan(P(FFTConfig(n=64)), device="cpu")
    z = torch.zeros(32, 128, dtype=torch.int32)
    with pytest.raises(ValueError):                  # wrong n
        plan(z, z)
    with pytest.raises(ValueError):                  # not a 2-D tile
        plan(z.reshape(64, 8, 8), z.reshape(64, 8, 8))
    with pytest.raises(ValueError):
        FusedAxisFFT(P(FFTConfig(n=64)), device="cpu")(z, z)          # last axis != n
