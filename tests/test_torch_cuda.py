"""The CUDA kernels (csrc/fused_pass.cu: the factor pass and the twiddle
generator; csrc/probe.cu: the ceiling probes; csrc/product.cu: the spectrum
product; csrc/probe_stages.cu: the per-stage probe) against their plain
versions on the card, and the port's plans and its convolution on the card against
golden.  Marked ``cuda``:
each test skips where no CUDA device is present; on a machine with an H100
run ``python -m pytest tests/test_torch_cuda.py`` (the first test builds
the kernel into build/)."""

import dataclasses

import numpy as np
import pytest
import torch

from intfftk_tpu_torch.config import FFTConfig
from intfftk_tpu_torch.golden import (fft_int, make_conv_spec,
                                      overlap_save_int)
from intfftk_tpu_torch.golden.float_model import bitrev_indices
from intfftk_tpu_torch.golden.four_step import four_step_int
from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan, circle_table,
                                              fused_pass,
                                              fused_pass_reference)
from intfftk_tpu_torch.ops.intmath import (spectrum_product,
                                           spectrum_product_reference)
from intfftk_tpu_torch.ops.single_pass import PallasFFTPlan, PallasWideFFTPlan
from intfftk_tpu_torch.ops.transform import pack_tables, pack_tables_2d
from intfftk_tpu_torch.ops.twiddle_synth import (EpiSynth, coarse_table,
                                                 device_circle_table,
                                                 synth_circle_block)
from intfftk_tpu_torch.parallel import Channelizer, OverlapSaveConv
from intfftk_tpu_torch.tools import audit_sass
from intfftk_tpu_torch.tools import probe_stages as ps
from intfftk_tpu_torch.tools import probe_vpu as pv

pytestmark = pytest.mark.cuda
MODES = [("unscaled", "truncate"), ("scaled", "truncate"), ("scaled", "round")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stimulus(shape, w, seed):
    rng = np.random.default_rng(seed)
    lim = 1 << (w - 1)
    xr = rng.integers(-lim, lim, shape)
    xi = rng.integers(-lim, lim, shape)
    xr[0] = -lim                    # full-scale adversarial first item
    xr[0, ::3] = lim - 1
    return xr, xi


@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("r,c,nb", [(8, 40, 3), (64, 40, 3), (256, 256, 4),
                                    (4096, 6, 2)])
@pytest.mark.parametrize("epi", [True, False], ids=["epi_turn", "plain"])
def test_kernel_vs_plain(dev, mode, rounding, r, c, nb, epi):
    """Both pass forms, ragged column tiles, int16 and int32 blocks."""
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    dt = torch.int16 if cfg.output_width <= 16 else torch.int32
    xr, xi = _stimulus((nb, r, c), 16, seed=r + c)
    x = [torch.as_tensor(v).to(dt).to(dev) for v in (xr, xi)]
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    e = (tuple(torch.as_tensor(t, device=dev) for t in circle_table(
        dataclasses.replace(cfg, n=r * 64), r, c)) if epi else None)
    before = fused_pass.launches
    yr, yi = fused_pass(*x, cfg, tables, epi=e, transpose_out=epi)
    torch.cuda.synchronize()
    assert fused_pass.launches == before + 1
    wr, wi = fused_pass_reference(*x, cfg, tables, epi=e, transpose_out=epi)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.parametrize("mode,rounding,bypass",
                         [m + (False,) for m in MODES]
                         + [("scaled", "truncate", True)])
def test_large_fft_on_card(dev, mode, rounding, bypass):
    cfg = FFTConfig(n=4096, mode=mode, rounding=rounding, bypass_fly=bypass)
    plan = LargeFFTPlan(cfg, 16, 256, device=dev)
    xr, xi = _stimulus((3, 4096), 16, seed=5)
    before = fused_pass.launches
    yr, yi = plan(torch.as_tensor(xr, device=dev),
                  torch.as_tensor(xi, device=dev))
    assert fused_pass.launches == before + 2
    gr, gi = four_step_int(xr, xi, cfg, 16, 256)
    np.testing.assert_array_equal(yr.cpu().numpy(), gr)
    np.testing.assert_array_equal(yi.cpu().numpy(), gi)


@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("r,c,nb", [(8, 40, 3), (256, 72, 2), (4096, 6, 2)])
@pytest.mark.parametrize("inverse,natural,turned,epi", [
    (False, False, False, True), (True, True, False, True),
    (True, False, False, True), (False, True, True, False),
    (True, False, True, False), (True, True, True, True)],
    ids=["fwd_raw_epi", "inv_nat_epi", "inv_raw_epi", "fwd_nat_turned",
         "inv_raw_turned", "inv_nat_turned_epi"])
def test_kernel_forms_vs_plain(dev, mode, rounding, r, c, nb, inverse,
                               natural, turned, epi):
    """The inverse, raw-order and transposed-load forms, ragged column
    tiles, int16 and int32 blocks, full-scale adversarial items."""
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    dt = torch.int16 if cfg.output_width <= 16 else torch.int32
    shape = (nb, c, r) if turned else (nb, r, c)
    xr, xi = _stimulus(shape, 16, seed=r + c + 1)
    x = [torch.as_tensor(v).to(dt).to(dev) for v in (xr, xi)]
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    e = (tuple(torch.as_tensor(t, device=dev) for t in circle_table(
        dataclasses.replace(cfg, n=r * 64), r, c, inverse,
        "natural" if natural else "raw")) if epi else None)
    kw = dict(epi=e, transpose_out=epi, inverse=inverse, natural=natural,
              transpose_in=turned)
    before = fused_pass.launches
    yr, yi = fused_pass(*x, cfg, tables, **kw)
    torch.cuda.synchronize()
    assert fused_pass.launches == before + 1
    wr, wi = fused_pass_reference(*x, cfg, tables, **kw)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("c", [1, 5, 33, 40])
@pytest.mark.parametrize("r", [8, 16, 32, 64])
@pytest.mark.parametrize("inverse,natural,turned_in,turned_out", [
    (False, True, False, False), (True, True, False, False),
    (False, False, False, True), (True, False, True, False)],
    ids=["fwd_nat", "inv_nat", "fwd_raw_turned_out", "inv_raw_turned_in"])
def test_group_splits_ragged_vs_plain(dev, mode, rounding, r, c, inverse,
                                      natural, turned_in, turned_out):
    """Every split of a factor into stage groups (m = 8: one group of 3;
    16: 3 + 1; 32: 3 + 2; 64: 3 + 3) on ragged column tiles, with the
    inter-factor product on the last group's registers: the first group
    reading device memory itself or the tile (turned load), the last
    writing device memory itself or the tile (turned store); int32 blocks,
    full-scale adversarial items; and on the int64 tile."""
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    shape = (3, c, r) if turned_in else (3, r, c)
    xr, xi = _stimulus(shape, 16, seed=r + c + 2)
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    e = tuple(torch.as_tensor(t, device=dev) for t in circle_table(
        dataclasses.replace(cfg, n=r * 64), r, c, inverse,
        "natural" if natural else "raw"))
    kw = dict(epi=e, transpose_out=turned_out, inverse=inverse,
              natural=natural, transpose_in=turned_in)
    for dt in (torch.int32, torch.int64):
        x = [torch.as_tensor(v).to(dt).to(dev) for v in (xr, xi)]
        before = fused_pass.launches
        yr, yi = fused_pass(*x, cfg, tables, out_dtype=dt, **kw)
        torch.cuda.synchronize()
        assert fused_pass.launches == before + 1
        wr, wi = fused_pass_reference(*x, cfg, tables, out_dtype=dt, **kw)
        assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
def test_group_split_of_the_library_on_card(dev, wide):
    """The split the kernel's host code computes is the Python one the
    audit sums a transform by."""
    for log_rows in range(3, 13):
        assert ps.library_group_split(log_rows, wide) == ps.group_split(
            log_rows, wide) == audit_sass.group_split(log_rows, wide)


@pytest.mark.parametrize("n", [8, 1024, 4096])
@pytest.mark.parametrize("order", ["natural", "bitrev"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("layout", ["nb", "bn"])
def test_pallas_plan_on_card(dev, layout, inverse, order, n):
    """PallasFFTPlan, one launch per call, ragged batches 3 and 200,
    scaled/round, against golden fft_int."""
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    plan = PallasFFTPlan(cfg, inverse=inverse, layout=layout, order=order,
                         device=dev)
    rev = bitrev_indices(n)
    for b in (3, 200):
        xr, xi = _stimulus((b, n), 16, seed=b + n)
        src = (xr[:, rev], xi[:, rev]) if order == "bitrev" and inverse \
            else (xr, xi)
        gr, gi = fft_int(*src, cfg, inverse=inverse)
        if order == "bitrev" and not inverse:
            gr, gi = gr[:, rev], gi[:, rev]
        if layout == "nb":
            xr, xi, gr, gi = xr.T, xi.T, gr.T, gi.T
        before = fused_pass.launches
        yr, yi = plan(torch.as_tensor(xr, device=dev),
                      torch.as_tensor(xi, device=dev))
        assert fused_pass.launches == before + 1
        np.testing.assert_array_equal(yr.cpu().numpy(), gr)
        np.testing.assert_array_equal(yi.cpu().numpy(), gi)


@pytest.mark.parametrize("mode,rounding", MODES)
def test_large_fft_raw_chain_on_card(dev, mode, rounding):
    """The raw forward then the swapped-factor raw inverse, 4 launches,
    against the golden natural composition."""
    cfg = FFTConfig(n=4096, mode=mode, rounding=rounding)
    icfg = dataclasses.replace(cfg, data_width=cfg.output_width)
    if mode == "unscaled":
        icfg = dataclasses.replace(icfg, mode="scaled", rounding="round")
    fwd = LargeFFTPlan(cfg, 16, 256, order="raw", device=dev)
    inv = LargeFFTPlan(icfg, 256, 16, inverse=True, order="raw", device=dev)
    xr, xi = _stimulus((3, 4096), 16, seed=6)
    before = fused_pass.launches
    y = fwd(torch.as_tensor(xr, device=dev), torch.as_tensor(xi, device=dev))
    z = inv(*y)
    assert fused_pass.launches == before + 4
    gr, gi = four_step_int(xr, xi, cfg, 16, 256)
    o = fwd.raw_spectrum_order()
    np.testing.assert_array_equal(y[0].cpu().numpy(), gr[:, o])
    hr, hi = four_step_int(gr, gi, icfg, 256, 16, inverse=True)
    np.testing.assert_array_equal(z[0].cpu().numpy(), hr)
    np.testing.assert_array_equal(z[1].cpu().numpy(), hi)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("layout", ["cn", "nc"])
def test_channelizer_stream_on_card(dev, layout, inverse):
    """The streamed Channelizer on CUDA streams with pinned staging:
    bursts of 1-96 channels, depth 3, bit-equal to golden, in order."""
    n, total = 256, 700
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    rng = np.random.default_rng(7)
    re = rng.integers(-(1 << 15), 1 << 15, (total, n))
    im = rng.integers(-(1 << 15), 1 << 15, (total, n))
    ex = Channelizer(cfg, inverse=inverse, layout=layout,
                     device=dev).stream(lane_tile=128, depth=3)
    pos, got = 0, []
    while pos < total:
        c = min(int(rng.integers(1, 97)), total - pos)
        got += list(ex.feed(re[pos:pos + c].T, im[pos:pos + c].T))
        pos += c
    got += list(ex.flush())
    gr, gi = fft_int(re, im, cfg, inverse=inverse)
    np.testing.assert_array_equal(
        np.concatenate([g[0] for g in got], axis=1).T, gr)
    np.testing.assert_array_equal(
        np.concatenate([g[1] for g in got], axis=1).T, gi)


@pytest.mark.parametrize("n,n1,n2", [(1 << 12, 16, 256), (1 << 18, 512, 512),
                                     (1 << 20, 1024, 1024)])
@pytest.mark.parametrize("gen", ["auto", "taylor_new"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_generator_vs_plain(dev, n, n1, n2, gen, inverse):
    """The generator kernel, one launch, == synth_circle_block == the host
    circle table."""
    cfg = FFTConfig(n=n, twiddle_gen=gen)
    before = device_circle_table.launches
    er, ei = device_circle_table(cfg, n, n1, n2, inverse, dev)
    torch.cuda.synchronize()
    assert device_circle_table.launches == before + 1
    assert er.device.type == "cuda" and er.dtype == torch.int32
    wr, wi = synth_circle_block(coarse_table(cfg, dev), n1, n2, 0, n, cfg,
                                inverse)
    assert torch.equal(er, wr) and torch.equal(ei, wi)
    hr, hi = circle_table(cfg, n1, n2, inverse)
    np.testing.assert_array_equal(er.cpu().numpy(), hr)
    np.testing.assert_array_equal(ei.cpu().numpy(), hi)


@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("r,c,nb,n", [(64, 40, 3, 1 << 12),
                                      (256, 256, 2, 1 << 16),
                                      (1024, 40, 3, 1 << 20),
                                      (4096, 6, 2, 1 << 24)])
@pytest.mark.parametrize("inverse,turned", [(False, False), (True, False),
                                            (False, True), (True, True)],
                         ids=["fwd", "inv", "fwd_turned", "inv_turned"])
def test_inkernel_epilogue_vs_plain(dev, mode, rounding, r, c, nb, n,
                                    inverse, turned):
    """The in-kernel synthesis epilogue, ragged column tiles (40 columns
    against a 32- or 16-column tile), int16 and int32 blocks, full-scale
    adversarial items."""
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    dt = torch.int16 if cfg.output_width <= 16 else torch.int32
    shape = (nb, c, r) if turned else (nb, r, c)
    xr, xi = _stimulus(shape, 16, seed=r + c + 2)
    x = [torch.as_tensor(v).to(dt).to(dev) for v in (xr, xi)]
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    syn = EpiSynth(*coarse_table(cfg, dev), n)
    kw = dict(synth=syn, transpose_out=True, inverse=inverse,
              transpose_in=turned)
    before = fused_pass.launches
    yr, yi = fused_pass(*x, cfg, tables, **kw)
    torch.cuda.synchronize()
    assert fused_pass.launches == before + 1
    wr, wi = fused_pass_reference(*x, cfg, tables, **kw)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("r,c,nb", [(8, 40, 3), (64, 40, 3), (256, 256, 2),
                                    (1024, 48, 2)])
@pytest.mark.parametrize("inverse,natural", [(False, True), (False, False),
                                             (True, True), (True, False)],
                         ids=["fwd", "fwd_raw", "inv", "inv_raw"])
def test_2d_pass_vs_plain(dev, mode, rounding, r, c, nb, inverse, natural):
    """The monolithic 2-D stage form (every stage multiplies, q = 0 and 1
    included), a ragged column count taking a prefix of the tables."""
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    dt = torch.int16 if cfg.output_width <= 16 else torch.int32
    c2 = 1 << (c - 1).bit_length()
    t2 = tuple(torch.as_tensor(t[:, :c]).contiguous().to(dev)
               for t in pack_tables_2d(FFTConfig(n=r * c2), r, c2))
    xr, xi = _stimulus((nb, r, c), 16, seed=r + c + 3)
    x = [torch.as_tensor(v).to(dt).to(dev) for v in (xr, xi)]
    for tout in (True, False):
        kw = dict(tables_2d=t2, transpose_out=tout, inverse=inverse,
                  natural=natural)
        before = fused_pass.launches
        yr, yi = fused_pass(*x, cfg, None, **kw)
        torch.cuda.synchronize()
        assert fused_pass.launches == before + 1
        wr, wi = fused_pass_reference(*x, cfg, None, **kw)
        assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.parametrize("epi_synth", ["host", "device", "inkernel"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_large_fft_epi_modes_on_card(dev, epi_synth, inverse):
    """The 256K split pipeline in each epilogue mode: 2 launches per call,
    one generator launch per device-mode plan, bit-equal to
    four_step_int."""
    cfg = FFTConfig(n=1 << 18, mode="scaled", rounding="round")
    gen_before = device_circle_table.launches
    plan = LargeFFTPlan(cfg, inverse=inverse, epi_synth=epi_synth,
                        device=dev)
    assert device_circle_table.launches == gen_before + (
        epi_synth == "device")
    xr, xi = _stimulus((2, 1 << 18), 16, seed=8)
    before = fused_pass.launches
    yr, yi = plan(torch.as_tensor(xr, device=dev),
                  torch.as_tensor(xi, device=dev))
    assert fused_pass.launches == before + 2
    gr, gi = four_step_int(xr, xi, cfg, plan.n1, plan.n2, inverse=inverse)
    np.testing.assert_array_equal(yr.cpu().numpy(), gr)
    np.testing.assert_array_equal(yi.cpu().numpy(), gi)


@pytest.mark.parametrize("n", [1 << 10, 1 << 16])
@pytest.mark.parametrize("inverse,order", [(False, "natural"),
                                           (True, "natural"), (False, "raw"),
                                           (True, "raw")],
                         ids=["fwd", "inv", "fwd_raw", "inv_raw"])
def test_monolithic_on_card(dev, n, inverse, order):
    """The monolithic schedule, 2 launches per call, bit-equal to fft_int
    (in the plan's raw layout with order="raw")."""
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    plan = LargeFFTPlan(cfg, inverse=inverse, order=order,
                        schedule="monolithic", device=dev)
    xr, xi = _stimulus((2, n), 16, seed=9)
    o = plan.raw_spectrum_order()
    if inverse and order == "raw":
        nr, ni = np.empty_like(xr), np.empty_like(xi)
        nr[:, o], ni[:, o] = xr, xi
        gr, gi = fft_int(nr, ni, cfg, inverse=True)
    else:
        gr, gi = fft_int(xr, xi, cfg, inverse=inverse)
        if order == "raw":
            gr, gi = gr[:, o], gi[:, o]
    before = fused_pass.launches
    yr, yi = plan(torch.as_tensor(xr, device=dev),
                  torch.as_tensor(xi, device=dev))
    assert fused_pass.launches == before + 2
    np.testing.assert_array_equal(yr.cpu().numpy(), gr)
    np.testing.assert_array_equal(yi.cpu().numpy(), gi)


# ------------------------------------------------- the wide (int64) forms

@pytest.mark.parametrize("mode,rounding", MODES)
@pytest.mark.parametrize("r,c,nb", [(8, 40, 3), (256, 40, 3), (512, 24, 2),
                                    (4096, 6, 2)])
@pytest.mark.parametrize("wide_in,inverse,natural,epi", [
    (False, False, True, True), (False, True, False, True),
    (False, False, True, False), (True, False, True, True),
    (True, False, False, False), (True, True, True, False),
    (True, True, False, True)],
    ids=["widen_fwd_epi", "widen_inv_raw_epi", "widen_fwd", "wide_fwd_epi",
         "wide_fwd_raw", "wide_inv", "wide_inv_raw_epi"])
def test_wide_pass_vs_plain(dev, mode, rounding, r, c, nb, wide_in, inverse,
                            natural, epi):
    """The int64-tile forms: int32 -> int64 (the widening pass, with and
    without the epilogue) and int64 -> int64, both directions and orders;
    ragged column tiles, m = 8/256/512/4096 (the TC change), full-scale
    52-bit data with 27-bit twiddles (the 80-bit product-sum) or 32-bit
    data into the widening pass."""
    lr = r.bit_length() - 1
    dw = 32 if not wide_in else (52 if mode == "scaled" else 52 - lr)
    cfg = FFTConfig(n=r, mode=mode, rounding=rounding, data_width=dw,
                    twiddle_width=27)
    xr, xi = _stimulus((nb, r, c), dw, seed=r + c + 4)
    in_dt = torch.int64 if wide_in else torch.int32
    x = [torch.as_tensor(v).to(in_dt).to(dev) for v in (xr, xi)]
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    e = (tuple(torch.as_tensor(t, device=dev) for t in circle_table(
        dataclasses.replace(cfg, n=r * 64), r, c, inverse,
        "natural" if natural else "raw")) if epi else None)
    kw = dict(epi=e, transpose_out=epi, inverse=inverse, natural=natural,
              out_dtype=torch.int64)
    before = fused_pass.launches
    yr, yi = fused_pass(*x, cfg, tables, **kw)
    torch.cuda.synchronize()
    assert fused_pass.launches == before + 1 and yr.dtype == torch.int64
    wr, wi = fused_pass_reference(*x, cfg, tables, **kw)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.parametrize("n", [8, 1024, 4096])
@pytest.mark.parametrize("order", ["natural", "bitrev"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_pallas_wide_plan_on_card(dev, inverse, order, n):
    """PallasWideFFTPlan (K5), one launch per call, ragged batches 3 and
    200, unscaled 32-bit data (output 35..44 bits), against golden
    fft_int."""
    cfg = FFTConfig(n=n, mode="unscaled", data_width=32)
    plan = PallasWideFFTPlan(cfg, inverse=inverse, order=order, device=dev)
    rev = bitrev_indices(n)
    for b in (3, 200):
        xr, xi = _stimulus((b, n), 32, seed=b + n + 1)
        src = (xr[:, rev], xi[:, rev]) if order == "bitrev" and inverse \
            else (xr, xi)
        gr, gi = fft_int(*src, cfg, inverse=inverse)
        if order == "bitrev" and not inverse:
            gr, gi = gr[:, rev], gi[:, rev]
        before = fused_pass.launches
        yr, yi = plan(torch.as_tensor(xr.T.copy(), device=dev),
                      torch.as_tensor(xi.T.copy(), device=dev))
        assert fused_pass.launches == before + 1
        np.testing.assert_array_equal(yr.cpu().numpy(), gr.T)
        np.testing.assert_array_equal(yi.cpu().numpy(), gi.T)


def test_large_wide_chain_on_card(dev):
    """The config-2 chain at n = 4096: the raw unscaled 32-bit forward (44
    bits out) then the raw scaled/round inverse at 44 bits, 4 launches,
    against the golden composition."""
    cfg = FFTConfig(n=4096, mode="unscaled", data_width=32, twiddle_width=20)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    fwd = LargeFFTPlan(cfg, order="raw", device=dev)
    inv = LargeFFTPlan(icfg, fwd.n2, fwd.n1, inverse=True, order="raw",
                       device=dev)
    xr, xi = _stimulus((3, 4096), 32, seed=10)
    before = fused_pass.launches
    y = fwd(torch.as_tensor(xr, device=dev), torch.as_tensor(xi, device=dev))
    z = inv(*y)
    assert fused_pass.launches == before + 4 and z[0].dtype == torch.int64
    gr, gi = four_step_int(xr, xi, cfg, fwd.n1, fwd.n2)
    o = fwd.raw_spectrum_order()
    np.testing.assert_array_equal(y[0].cpu().numpy(), gr[:, o])
    hr, hi = four_step_int(gr, gi, icfg, inv.n1, inv.n2, inverse=True)
    np.testing.assert_array_equal(z[0].cpu().numpy(), hr)
    np.testing.assert_array_equal(z[1].cpu().numpy(), hi)


@pytest.mark.parametrize("k", [0, 1, 5, 64])
@pytest.mark.parametrize("body", pv.INT32_BODIES)
def test_probe_chain_int32_on_card(dev, body, k):
    """K7: every chain body equal to its plain version, two CTAs."""
    n = 2 * pv.cta_elems()
    x = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                      device=dev, generator=torch.Generator(
                          device=dev).manual_seed(k))
    before = pv.probe_chain.launches
    y = pv.probe_chain(body, x, k)
    torch.cuda.synchronize()
    assert pv.probe_chain.launches == before + 1
    assert torch.equal(y, pv.chain_reference(body, x, k))


@pytest.mark.parametrize("k", [0, 1, 5, 64])
@pytest.mark.parametrize("body", pv.INT16_BODIES)
def test_probe_chain_int16_on_card(dev, body, k):
    """K9: the int16 add chain, one element and two per register."""
    n = 4 * pv.cta_elems()
    x = torch.randint(-(1 << 15), 1 << 15, (n,), dtype=torch.int16,
                      device=dev, generator=torch.Generator(
                          device=dev).manual_seed(k))
    before = pv.probe_chain.launches_int16
    y = pv.probe_chain(body, x, k)
    torch.cuda.synchronize()
    assert pv.probe_chain.launches_int16 == before + 1
    assert torch.equal(y, pv.chain_reference(body, x, k))


def test_probe_copy_and_refusals_on_card(dev):
    """K8: o = x + 1, the wrap at INT32_MAX included; what the kernels do
    not take raises."""
    x = torch.arange(-(1 << 20), 1 << 20, dtype=torch.int32, device=dev)
    x[:2] = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32)
    before = pv.probe_copy.launches
    y = pv.probe_copy(x)
    torch.cuda.synchronize()
    assert pv.probe_copy.launches == before + 1
    assert torch.equal(y, pv.copy_reference(x))
    with pytest.raises(ValueError, match="multiple of 4"):
        pv.probe_copy(x[:6].clone())
    with pytest.raises(ValueError, match="multiple of"):
        pv.probe_chain("add", x[:100].clone(), 1)
    with pytest.raises(ValueError, match="multiple of"):
        pv.probe_chain("add_packed", torch.zeros(
            pv.cta_elems(), dtype=torch.int16, device=dev), 1)


def test_probe_guards_on_card(dev):
    """A short reading of each mixed chain passes both guards, the copy
    reads below the card's memory peak, and the ceilings are the better
    chain and that peak."""
    peak = pv.lane_rate_peak(dev)
    x = pv.chain_input(torch.int32, dev)
    for body in ("mixed7", "stagemix10"):
        r = pv.chain_ops_per_s(body, target_ms=pv.TARGET_MS_QUICK, x=x)
        pv.check_reading(r, peak)
        assert r.ops_per_s > 0 and r.ks[2] % pv.K_BASE[2] == 0
    assert 1e12 < pv.probe_hbm(1 << 26, dev) <= pv.memory_peak(dev) < 1e13
    ops, byts = pv.same_session_ceilings(quick=True, device=dev)
    assert ops > 1e13 and byts == pv.memory_peak(dev)


@pytest.mark.parametrize("case", ["n256_complex", "n4096_batched",
                                  "n16k_wide"])
def test_convolution_on_card(dev, case):
    """OverlapSaveConv on the card against golden overlap_save_int: the
    single-pass pair (2 launches) and the four-step pair with a 44-bit
    product (4 launches)."""
    kw, batch, launches, dtype = {
        "n256_complex": (dict(n=256, taps_len=33, data_width=12,
                              taps_width=12), (), 2, torch.int32),
        "n4096_batched": (dict(n=4096, taps_len=513, rounding="round"), (3,),
                          2, torch.int32),
        "n16k_wide": (dict(n=1 << 14, taps_len=(1 << 11) + 1,
                           twiddle_width=16, max_product_width=44,
                           max_spectrum_width=25), (), 4, torch.int64),
    }[case]
    spec = make_conv_spec(**kw)
    rng = np.random.default_rng(spec.n)
    lim = 1 << (spec.taps_width - 2)
    h = rng.integers(-lim, lim, (2, spec.taps_len))
    x = rng.integers(-lim, lim, (2,) + batch + (3 * spec.payload,))
    conv = OverlapSaveConv(spec, *h, device=dev)
    before = fused_pass.launches
    yr, yi = conv(*x)
    torch.cuda.synchronize()
    assert fused_pass.launches == before + launches and yr.dtype == dtype
    gr, gi = overlap_save_int(*x, *h, spec)
    np.testing.assert_array_equal(yr.cpu().numpy(), gr)
    np.testing.assert_array_equal(yi.cpu().numpy(), gi)
    if conv.large:
        pr, pi = conv(*x, pass_fn=fused_pass_reference)
        assert torch.equal(pr, yr) and torch.equal(pi, yi)


def test_default_device_is_the_card(dev):
    """With no device argument every entry point builds on the card."""
    cfg = FFTConfig(n=4096)
    assert LargeFFTPlan(cfg, 16, 256).w1r.device.type == "cuda"
    assert PallasFFTPlan(cfg).w_re.device.type == "cuda"
    assert Channelizer(cfg).device.type == "cuda"
    assert device_circle_table(cfg, 4096, 16, 256, False)[0].is_cuda


@pytest.mark.parametrize("case", [
    # data bits, dtype, spectrum bits, shift, out bits, out dtype, shape
    (32, torch.int32, 25, 14, 44, torch.int64, (4, 128, 128), (128, 128)),
    (48, torch.int64, 25, 23, 48, torch.int64, (2, 128, 128), (128, 128)),
    (63, torch.int64, 27, 26, 63, torch.int64, (3, 1022), (1022,)),
    (32, torch.int32, 16, 15, 32, torch.int32, (3, 4096), (4096,)),
    (30, torch.int64, 25, 24, 30, torch.int32, (5, 1024), (1024,)),
    (30, torch.int64, 25, 24, 30, torch.int64, (5, 1024), (1024,)),
    (32, torch.int32, 25, 14, 44, torch.int64, (3, 1023), (1023,)),
    (32, torch.int32, 25, 14, 44, torch.int64, (1, 1), (1,)),
], ids=["c4_int32_int64", "c2_int64_int128", "int64_63_27", "int32_int32",
        "int64_int32", "int64_long_long", "ragged_1023", "one_element"])
def test_spectrum_product_on_card(dev, case):
    """P1: every (data, product-sum, output) form at full scale, aligned
    runs and ragged counts, equal to its plain version."""
    dw, dt, sw, shift, ow, odt, shape, block = case
    g = torch.Generator(device=dev).manual_seed(dw + sw)

    def rnd(shp, bits, dtype):
        lim = 1 << (bits - 1)
        v = torch.randint(-lim, lim, shp, dtype=torch.int64, device=dev,
                          generator=g)
        v.view(-1)[0] = -lim
        v.view(-1)[-1] = lim - 1
        return v.to(dtype)

    args = (rnd(shape, dw, dt), rnd(shape, dw, dt),
            rnd(block, sw, torch.int32), rnd(block, sw, torch.int32))
    before = spectrum_product.launches
    yr, yi = spectrum_product(*args, shift, ow, sw, odt)
    torch.cuda.synchronize()
    assert spectrum_product.launches == before + 1 and yr.dtype == odt
    wr, wi = spectrum_product_reference(*args, shift, ow, sw, odt)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


def test_spectrum_product_refusals_on_card(dev):
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        spectrum_product(z(4, 8)[:, ::2], z(4, 8)[:, ::2], z(4), z(4), 1, 16)
    with pytest.raises(ValueError, match="one device"):
        spectrum_product(z(4, 4), z(4, 4), z(4).cpu(), z(4).cpu(), 1, 16)
    yr, _ = spectrum_product(z(0, 4), z(0, 4), z(4), z(4), 1, 16)
    assert tuple(yr.shape) == (0, 4)


def test_pass_at_batch_65536_on_card(dev):
    """More items than one grid dimension holds: one call, two launches
    (both counted), every item equal to the plain version."""
    cfg = FFTConfig(n=8, mode="scaled", rounding="round", data_width=16,
                    twiddle_width=16)
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    xr, xi = _stimulus((65536 + 3, 8, 5), 16, seed=65536)
    x = [torch.as_tensor(v).to(torch.int16).to(dev) for v in (xr, xi)]
    before = fused_pass.launches
    y = fused_pass(*x, cfg, tables, transpose_out=True)
    torch.cuda.synchronize()
    assert fused_pass.launches == before + 2
    w = fused_pass_reference(*x, cfg, tables, transpose_out=True)
    assert torch.equal(y[0], w[0]) and torch.equal(y[1], w[1])


def test_tall_tile_steps_on_card(dev):
    """K10 on the tallest tile, [4096, 4] with rows padded to 5 words:
    ``TALL_STEPS`` equal to their plain versions in both configs."""
    worst = ps.bit_checks(dev, ps.TALL_ROWS, ps.TALL_STEPS)
    assert set(worst) == set(ps.TALL_STEPS) and max(worst.values()) == 0


@pytest.mark.parametrize("config", [ps.check_config, ps.probe_config],
                         ids=["unscaled", "scaled_round"])
@pytest.mark.parametrize("step", list(ps.STEPS))
def test_stage_step_on_card(dev, step, config):
    """K10: the once and the loop kernel of every step equal to its plain
    version, and a variant to its production step, with full-scale columns,
    on live unscaled data and on the scaled/round config the tool times (so
    a fixed-mode step's kernel of either mode is compared); two CTAs."""
    cfg = config()
    s = ps.STEPS[step]
    tc, _ = ps.geometry(step, cfg.n, dev.index or 0)
    dt = torch.int64 if s.wide else torch.int32
    xr, xi = (torch.as_tensor(v).to(dt).to(dev)
              for v in _stimulus((cfg.n, 2 * tc), 16, seed=s.order + 1))
    tables = ps.stage_tables(cfg, dev)
    epi = ps.epilogue_table(cfg, tc, dev)
    for once, k in ((True, 1), (False, 1), (False, ps.check_k(step, cfg))):
        before = ps.stage_loop.launches
        got = ps.stage_loop(step, xr, xi, k, cfg, tables, epi, once=once)
        torch.cuda.synchronize()
        assert ps.stage_loop.launches == before + 1
        want = ps.stage_loop_reference(step, xr, xi, k, cfg, tables, epi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if s.variant_of:
            prod = ps.stage_loop(s.variant_of, xr, xi, k, cfg, tables, epi,
                                 once=once)
            assert torch.equal(got[0], prod[0])
            assert torch.equal(got[1], prod[1])
    with pytest.raises(ValueError, match="multiple of"):
        ps.stage_loop(step, xr[:, :tc - 1].contiguous(),
                      xi[:, :tc - 1].contiguous(), 1, cfg, tables, epi)


def test_stage_probe_and_audit_on_card(dev):
    """One quick reading of a production step passes both guards, and the
    library's SASS parses: no opcode without a class, the chain that sets
    the ceiling counted, a count for every step."""
    peak = pv.lane_rate_peak(dev)
    r = ps.stage_rate("prod_p7", target_ms=pv.TARGET_MS_QUICK, device=dev)
    ps.check_reading(r, peak)
    assert 1e-4 < r.ns_per_sample_per_stage < 1e-1
    sass = audit_sass.library_sass()
    assert not [i.opcode for ins in sass.values() for i in ins
                if audit_sass.classify(i.opcode) == "unknown"]
    per = audit_sass.audit_probe_chain("mixed7", sass).scaled(
        audit_sass.CHAINS_PER_THREAD)
    assert 1 <= audit_sass.issued(per) <= pv.BODIES["mixed7"].ops
    for step in ps.STEPS:
        assert audit_sass.issued(audit_sass.audit_stage(step, sass)) > 0
    head = audit_sass.audit_headline(sass)
    assert audit_sass.issued(head["int64"]["per_sample"]) > audit_sass.issued(
        head["narrow"]["per_sample"])


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("rank", range(4))
def test_four_step_rank_passes_on_card(dev, rank, inverse):
    """Each rank's passes of the sharded four-step at D = 4, 1024 x 1024
    (config 5, scaled/round 16-bit, batch 2): the column pass (the
    epilogue from this rank's [1024, 256] column slice, k1 rows stored
    outermost) and the row pass in both store layouts, one launch each on
    the card, equal to the plain version on the CPU."""
    from intfftk_tpu_torch.parallel import (FourStepPasses, column_pass,
                                            row_pass)
    cfg = FFTConfig(n=1 << 20, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    xc = _stimulus((2, 1024 * 256), 16, 40 + rank)
    xr_ = _stimulus((2, 256 * 1024), 16, 50 + rank)
    for natural_out in (True, False):
        on = {d: FourStepPasses(cfg, 1024, 1024, inverse, natural_out,
                                rank=rank, size=4, device=d)
              for d in (dev, "cpu")}
        for fn, x, shape in ((column_pass, xc, (2, 1024, 256)),
                             (row_pass, xr_, (2, 256, 1024))):
            if fn is column_pass and not natural_out:
                continue                  # the column pass has one layout
            got, want = ([torch.as_tensor(v.reshape(shape), dtype=torch.int32,
                                          device=d) for v in x]
                         for d in (dev, "cpu"))
            before = fused_pass.launches
            got = fn(*got, on[dev], rank, 4)
            assert fused_pass.launches == before + 1
            want = fn(*want, on["cpu"], rank, 4)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), (fn.__name__, natural_out)
