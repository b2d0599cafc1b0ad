"""The CUDA kernels (csrc/fused_pass.cu: the factor pass and the twiddle
generator; csrc/fused_whole.cuh: the whole four-step as a thread-block
cluster; csrc/probe.cu: the ceiling probes; csrc/product.cu: the spectrum
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
                                              fused_four_step_reference,
                                              fused_pass,
                                              fused_pass_reference,
                                              fused_whole)
from intfftk_tpu_torch.ops.intmath import (spectrum_product,
                                           spectrum_product_reference)
from intfftk_tpu_torch.ops.single_pass import PallasFFTPlan, PallasWideFFTPlan
from intfftk_tpu_torch.ops.tuning import device_tuning, whole_cluster
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
                                     (1 << 19, 1024, 512),
                                     (1 << 20, 1024, 1024),
                                     (1 << 20, 1024, 1022),
                                     (1 << 20, 1000, 1000),
                                     (1 << 18, 70000, 3)])
@pytest.mark.parametrize("gen", ["auto", "taylor_new"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_generator_vs_plain(dev, n, n1, n2, gen, inverse):
    """The generator kernel, one launch, == synth_circle_block == the host
    circle table, square, non-square and ragged, into an ``out`` pair that
    is not 16-byte aligned (the scalar stores) too; its launch the
    rule's."""
    from intfftk_tpu_torch.ops.twiddle_synth import circle_launch
    cfg = FFTConfig(n=n, twiddle_gen=gen)
    before = device_circle_table.launches
    er, ei = device_circle_table(cfg, n, n1, n2, inverse, dev)
    torch.cuda.synchronize()
    assert device_circle_table.launches == before + 1
    assert er.device.type == "cuda" and er.dtype == torch.int32
    assert device_circle_table.launch == circle_launch(n1, n2)
    wr, wi = synth_circle_block(coarse_table(cfg, dev), n1, n2, 0, n, cfg,
                                inverse)
    assert torch.equal(er, wr) and torch.equal(ei, wi)
    hr, hi = circle_table(cfg, n1, n2, inverse)
    np.testing.assert_array_equal(er.cpu().numpy(), hr)
    np.testing.assert_array_equal(ei.cpu().numpy(), hi)
    buf = [torch.zeros(n1 * n2 + 1, dtype=torch.int32, device=dev)
           for _ in range(2)]
    out = [b[1:].view(n1, n2) for b in buf]
    device_circle_table(cfg, n, n1, n2, inverse, dev, out=out)
    assert torch.equal(out[0], er) and torch.equal(out[1], ei)
    assert int(buf[0][0]) == int(buf[1][0]) == 0


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_generator_16m_and_captured(dev, inverse):
    """The 16M table (4096 x 4096, "taylor_new" has no constant there) ==
    the host circle table; and the call with ``coarse`` and ``out`` given,
    captured into a CUDA graph, replays to the same table."""
    from intfftk_tpu_torch.runtime import captured
    n, n1 = 1 << 24, 4096
    cfg = FFTConfig(n=n)
    co = coarse_table(cfg, dev)
    er, ei = device_circle_table(cfg, n, n1, n1, inverse, coarse=co)
    hr, hi = circle_table(cfg, n1, n1, inverse)
    np.testing.assert_array_equal(er.cpu().numpy(), hr)
    np.testing.assert_array_equal(ei.cpu().numpy(), hi)
    out = [torch.zeros_like(er) for _ in range(2)]
    call = captured(lambda u, v: (device_circle_table(
        cfg, n, n1, n1, inverse, coarse=co, out=out), (u, v))[1])
    x = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2)]
    call(*x)
    out[0].zero_()
    call(*x)
    torch.cuda.synchronize()
    assert torch.equal(out[0], er) and torch.equal(out[1], ei)


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


# ------------------------------- the skewed tile of the turned natural store

#: The forms of the forward pass that store turned and in natural order:
#: (input dtype, output dtype, epilogue, turned load).
SKEW_FORMS = {
    "i16_synth_turned": (torch.int16, torch.int16, "synth", True),
    "i32_table": (torch.int32, torch.int32, "table", False),
    "i32_turned": (torch.int32, torch.int32, None, True),
    "i32_i64_table": (torch.int32, torch.int64, "table", False),
    "i64": (torch.int64, torch.int64, None, False),
}


def _skew_cfg(r, in_dt, out_dt):
    if out_dt == torch.int64:
        dw = 32 if in_dt == torch.int32 else 52 - (r.bit_length() - 1)
        return FFTConfig(n=r, mode="unscaled", data_width=dw,
                         twiddle_width=20)
    if in_dt == torch.int16:
        return FFTConfig(n=r, mode="scaled", rounding="round", data_width=16,
                         twiddle_width=16)
    return FFTConfig(n=r, mode="unscaled", data_width=16, twiddle_width=16)


@pytest.mark.parametrize("form", list(SKEW_FORMS))
@pytest.mark.parametrize("r", [32, 64, 256, 512, 1024, 4096])
def test_skewed_pass_vs_plain(dev, r, form):
    """The forward's store turned and in natural order, on the skewed tile
    (``tuning.tile_skew``; 32 rows: the int32 tile's padded one): int16
    and int32 blocks on the int32 tile, int32 -> int64 and int64 on the
    int64 tile, the epilogue from a table, synthesized in the kernel or
    none, with a turned load beside it; 37 columns (a tail tile at every
    TC), full-scale adversarial items.  The prepared pass reports the
    rule's skew and the shared memory ``tuning.tile_bytes`` counts (less
    the coarse table where it stages none); the bits equal the plain
    version's through the prepared chain and through ``fused_pass``."""
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain
    from intfftk_tpu_torch.ops.tuning import (COARSE_BYTES, tile_bytes,
                                              tile_skew)

    in_dt, out_dt, epi, turned = SKEW_FORMS[form]
    cfg = _skew_cfg(r, in_dt, out_dt)
    c, nb = 37, 2
    shape = (nb, c, r) if turned else (nb, r, c)
    xr, xi = _stimulus(shape, cfg.data_width, seed=r + 7)
    x = [torch.as_tensor(v).to(in_dt).to(dev) for v in (xr, xi)]
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    kw = dict(transpose_out=True, transpose_in=turned, out_dtype=out_dt)
    if epi == "table":
        kw["epi"] = tuple(torch.as_tensor(t, device=dev) for t in circle_table(
            dataclasses.replace(cfg, n=r * 64), r, c))
    elif epi == "synth":
        kw["synth"] = EpiSynth(*coarse_table(cfg, dev),
                               1 << max(12, r.bit_length() + 5))
    chain = PreparedChain(x[0].shape, in_dt, x[0].device,
                          [(cfg, dict(tables=tables, **kw))])
    word = out_dt.itemsize if out_dt == torch.int64 else 4
    skew = tile_skew(r, word)
    assert chain.passes[0].skew == skew and chain.skewed == int(skew > 0)
    assert skew > 0 or (r, word) == (32, 4)
    tc = chain.passes[0].geometry[0]
    assert chain.passes[0].geometry[2] == tile_bytes(r, tc, word) - (
        0 if epi == "synth" else COARSE_BYTES)
    y = chain(*x)
    yr, yi = fused_pass(*x, cfg, tables, **kw)
    torch.cuda.synchronize()
    wr, wi = fused_pass_reference(*x, cfg, tables, **kw)
    assert torch.equal(y[0], wr) and torch.equal(y[1], wi)
    assert torch.equal(yr, wr) and torch.equal(yi, wi)


@pytest.mark.parametrize("form", ["core_pass1", "channelizer_cn",
                                  "widen_256", "wide_256"])
def test_skewed_instances_spill_nothing_on_card(dev, form):
    """Each skewed instance a forward pass of these shapes takes, in both
    product forms, at the geometry the card's row gives it: registers
    within the cap of ``min_ctas`` and as many CTAs per SM as the padded
    instance; no local memory in the modular forms (every skewed pass the
    benchmark runs) nor on the int64 tile; the int32 tile's exact forms
    keep one word of their prologue in local memory (no cell runs them).
    The inverse has no skewed instance."""
    import ctypes

    from intfftk_tpu_torch.ops import _build
    from intfftk_tpu_torch.ops.tuning import pass_geometry

    rows, cols, size_in, size_out = {
        "core_pass1": (256, 256, 2, 2), "channelizer_cn": (4096, 4096, 4, 4),
        "widen_256": (256, 256, 4, 8), "wide_256": (256, 256, 8, 8)}[form]
    g = pass_geometry(device_tuning(dev), rows, cols, size_out == 8)
    lib = _build.library(g["threads"])
    device = torch.cuda.current_device()
    read = {}
    for product in (0, 1):
        for skew in (0, 1):
            out = (ctypes.c_int * 5)()
            assert lib.intfft_pass_attributes(
                size_in, size_out, 0, 0, rows, g["lane_tile"], g["threads"],
                int(size_out < 8), product, skew, 0, device, out) == 0
            read[product, skew] = tuple(out)
    cap = 128 if size_out == 8 else 64
    for product in (0, 1):
        padded, skewed = read[product, 0], read[product, 1]
        assert skewed[0] <= cap and skewed[3] == padded[3], read
        assert padded[1] == 0, read
        assert skewed[1] <= (8 if size_out < 8 and product == 0 else 0), read
    out = (ctypes.c_int * 5)()
    assert lib.intfft_pass_attributes(
        size_in, size_out, 1, 0, rows, g["lane_tile"], g["threads"], 0, 1,
        1, 0, device, out) != 0


# ------------------------------------ each tile's two forms of the product

#: The exact form of each tile's modular form.
EXACT = {"mod32": "int32", "mod64": "limb64"}


def _forced(monkeypatch):
    """Every pass takes its tile's exact form ("int32", "limb64") from
    here on, where the rule would give it the modular one: the rule as the
    launch paths read it, replaced."""
    from intfftk_tpu_torch.ops import fused_fft

    rule = fused_fft.product_form

    def pick(*args, **kw):
        got = rule(*args, **kw)
        return EXACT.get(got, got)

    monkeypatch.setattr(fused_fft, "product_form", pick)


def _conv4(dev, product_width=44):
    spec = make_conv_spec(n=1 << 16, taps_len=(1 << 13) + 1,
                          twiddle_width=16, max_product_width=product_width,
                          max_spectrum_width=25)
    rng = np.random.default_rng(spec.taps_len)
    lim = 1 << 13
    h = rng.integers(-lim, lim, (2, spec.taps_len))
    return spec, h, OverlapSaveConv(spec, *h, device=dev)


def test_conv4_inverse_passes_both_forms_on_card(dev, monkeypatch):
    """Config 4's inverse (scaled 44-bit, 16-bit twiddles: 59 bits kept)
    on full-scale adversarial 44-bit spectra: the chain takes the modular
    form in both passes, per pass equal to the plain version, and equal to
    the same passes forced to the exact form, in limbs."""
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain

    _, _, conv = _conv4(dev)
    inv = conv.pair.inv
    xr, xi = _stimulus((3,) + inv.block_in_shape, 44, seed=44)
    x = [torch.as_tensor(v, dtype=torch.int64, device=dev) for v in (xr, xi)]
    key = (x[0].shape, x[0].dtype, x[0].device)
    chain = PreparedChain(*key, inv.passes())
    assert chain.products == ("mod64", "mod64")
    got = chain(*x)
    want = x
    for cfg, kw in inv.passes():
        one = fused_pass(*want, cfg, **kw)
        want = fused_pass_reference(*want, cfg, **kw)
        assert torch.equal(one[0], want[0]) and torch.equal(one[1], want[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _forced(monkeypatch)
    exact = PreparedChain(*key, inv.passes())
    assert exact.products == ("limb64", "limb64")
    ex = exact(*x)
    assert torch.equal(ex[0], got[0]) and torch.equal(ex[1], got[1])


@pytest.mark.parametrize("payloads", [4, 64])
def test_conv4_against_golden_on_card(dev, payloads):
    """The benchmark's convolution (BASELINE config 4) at T = 4 and 64
    payloads, full-scale 14-bit signal, against golden overlap_save_int:
    the inverse's two passes modular, the output int64 and bit-equal."""
    from intfftk_tpu_torch.runtime import trace

    spec, h, conv = _conv4(dev)
    rng = np.random.default_rng(payloads)
    lim = 1 << 13
    x = rng.integers(-lim, lim, (2, payloads * spec.payload))
    x[0, ::7] = -lim
    x[1, ::5] = lim - 1
    with trace.recording() as rec:
        yr, yi = conv(*x)
    torch.cuda.synchronize()
    notes = [s.note for s in rec.spans if s.name == "plan.prepare"]
    assert ("product int32 0 mod32 0 mod64 2 limb64 0 int128 0 skew 0 "
            "epi host 524288") in notes
    assert ("product int32 2 mod32 0 mod64 0 limb64 0 int128 0 skew 0 "
            "epi host 524288") in notes
    gr, gi = overlap_save_int(*x, *h, spec)
    assert yr.dtype == torch.int64
    np.testing.assert_array_equal(yr.cpu().numpy(), gr)
    np.testing.assert_array_equal(yi.cpu().numpy(), gi)


@pytest.mark.parametrize("payloads, rows", [(1, 1), (4, 3), (64, 1)])
def test_conv4_edges_captured_against_golden(dev, payloads, rows):
    """The benchmark's convolution with its edges (the forward's pass 1
    reading the signal in place, the inverse's pass 2 writing the output
    in place), captured, at T = 1, 4 and 64 payloads (4 on three signal
    rows, each with its own block 0), full-scale 14-bit samples on every
    row's first and last block: bit-equal to golden overlap_save_int and
    to the eager call, on a first input and (T <= 4) on a replay with
    new inputs."""
    spec, h, conv = _conv4(dev)
    assert conv.edges == ("window", "cut")
    rng = np.random.default_rng(100 + payloads)
    lim = 1 << 13
    t = payloads * spec.payload
    call = conv.capture()
    for _ in range(1 if payloads == 64 else 2):
        x = rng.integers(-lim, lim, (2, rows, t))
        x[0, :, :spec.payload:3] = lim - 1
        x[1, :, -spec.payload::7] = -lim
        xd = [torch.as_tensor(v, dtype=torch.int32, device=dev) for v in x]
        yr, yi = call(*xd)
        er, ei = conv(*xd)
        torch.cuda.synchronize()
        assert yr.shape == (rows, t) and yr.dtype == torch.int64
        assert torch.equal(yr, er) and torch.equal(yi, ei)
        gr, gi = overlap_save_int(*x, *h, spec)
        np.testing.assert_array_equal(yr.cpu().numpy(), gr)
        np.testing.assert_array_equal(yi.cpu().numpy(), gi)


def test_conv4_captured_call_runs_no_torch_kernel(dev):
    """Under torch.profiler a replay of the captured convolution with its
    edges runs the port's five kernels (four passes and P1) and no kernel,
    copy or fill of torch's or the CUDA runtime's (the names
    ``glue_ms_per_call`` reads)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec, _, conv = _conv4(dev)
    x = [torch.ones(4 * spec.payload, dtype=torch.int32, device=dev)
         for _ in range(2)]
    call = conv.capture()
    call(*x)
    static = call.static_inputs(*x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call(*static)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    assert sum("fused_pass_kernel" in n for n in names) == 12, names
    assert sum("product_kernel" in n for n in names) == 3, names
    glue = ("at::native::", "at::cuda::", "memcpy", "memset")
    assert not [n for n in names if any(g in n.lower() for g in glue)]


def test_conv4_edge_kernels_spill_nothing(dev):
    """The two edge instances at the geometry their passes launch with
    (``intfft_pass_attributes``): no local memory, registers within the
    cap of ``min_ctas``, and as many CTAs per SM as their plain twins."""
    import ctypes

    from intfftk_tpu_torch.ops import _build

    _, _, conv = _conv4(dev)
    device = torch.cuda.current_device()
    for edge, (plan, i, size, inverse, product) in enumerate(
            ((conv.pair.fwd, 0, 4, 0, 0), (conv.pair.inv, 1, 8, 1, 1)), 1):
        g = plan.pass_geometry[i]
        lib = _build.library(g["threads"])
        read = []
        for e in (0, edge):
            out = (ctypes.c_int * 5)()
            assert lib.intfft_pass_attributes(
                size, size, inverse, 0, 256, g["lane_tile"], g["threads"], 0,
                product, 0, e, device, out) == 0
            read.append(tuple(out))
        plain, edged = read
        assert edged[1] == 0 and edged[0] <= (128 if size == 8 else 64), read
        assert edged[3] == plain[3], read
        # the edge of the other form is refused
        out = (ctypes.c_int * 5)()
        assert lib.intfft_pass_attributes(
            size, size, inverse, 0, 256, g["lane_tile"], g["threads"], 0,
            1 - product, 0, edge, device, out) != 0


def test_config2_chain_both_forms_on_card(dev, monkeypatch):
    """BASELINE config 2's 64k chain (unscaled 32-bit forward to 48 bits,
    20-bit twiddles; the scaled/round inverse at 48): the forward's passes
    modular (its pass 2 at the bound, 46 + 18 = 64), the inverse's exact;
    both transforms equal to golden four_step_int, and the forward equal
    to itself forced to the exact form."""
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain

    cfg = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                    twiddle_width=20)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    fwd = LargeFFTPlan(cfg, order="raw", device=dev)
    inv = LargeFFTPlan(icfg, fwd.n2, fwd.n1, inverse=True, order="raw",
                       device=dev)
    xr, xi = _stimulus((2, 1 << 16), 32, seed=2)
    x = [torch.as_tensor(v, dtype=torch.int32, device=dev).reshape(
        (2,) + fwd.block_in_shape) for v in (xr, xi)]
    key = (x[0].shape, x[0].dtype, x[0].device)
    cf = PreparedChain(*key, fwd.passes())
    assert cf.products == ("mod64", "mod64")
    y = cf(*x)
    ci = PreparedChain(y[0].shape, y[0].dtype, y[0].device,
                       inv.passes())
    assert ci.products == ("limb64", "limb64")
    z = ci(*y)
    torch.cuda.synchronize()
    gr, gi = four_step_int(xr, xi, cfg, fwd.n1, fwd.n2)
    o = fwd.raw_spectrum_order()
    np.testing.assert_array_equal(y[0].cpu().numpy().reshape(2, -1),
                                  gr[:, o])
    np.testing.assert_array_equal(y[1].cpu().numpy().reshape(2, -1),
                                  gi[:, o])
    hr, hi = four_step_int(gr, gi, icfg, inv.n1, inv.n2, inverse=True)
    np.testing.assert_array_equal(z[0].cpu().numpy().reshape(2, -1), hr)
    np.testing.assert_array_equal(z[1].cpu().numpy().reshape(2, -1), hi)
    _forced(monkeypatch)
    ce = PreparedChain(*key, fwd.passes())
    assert ce.products == ("limb64", "limb64")
    e = ce(*x)
    assert torch.equal(e[0], y[0]) and torch.equal(e[1], y[1])


def _limb_items(shape, w, seed):
    """[B, R, C] w-bit items, B >= 3, that drive the exact int64 form to its
    edges: item 0 at the top value in the first half of its rows and the
    least in the second (imaginary the other way), item 1 the two by turns
    row by row, so that the forward's and the inverse's first butterflies
    meet (max, min) and the round mode's difference wraps; item 2 at the
    top value throughout, whose sums reach the top of the output width;
    the others uniform over the w bits."""
    lo, hi = -(1 << (w - 1)), (1 << (w - 1)) - 1
    xr, xi = _stimulus(shape, w, seed)
    half = shape[1] // 2
    xr[0, :half], xr[0, half:] = hi, lo
    xi[0, :half], xi[0, half:] = lo, hi
    xr[1, 0::2], xr[1, 1::2] = hi, lo
    xi[1, 0::2], xi[1, 1::2] = lo, hi
    xr[2], xi[2] = hi, hi
    return xr, xi


def test_config2_inverse_limb_passes_on_card(dev):
    """Config 2's inverse (scaled, round-half-up, 48 bits, 20-bit twiddles:
    shift 18, so 66 bits kept: the limbs in both passes) on full-scale
    adversarial 48-bit items: each pass equal to the plain version, the
    prepared chain equal to the passes."""
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain

    cfg = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                    twiddle_width=20)
    icfg = dataclasses.replace(cfg, mode="scaled", rounding="round",
                               data_width=cfg.output_width)
    inv = LargeFFTPlan(icfg, 256, 256, inverse=True, order="raw",
                       device=dev)
    xr, xi = _limb_items((4,) + inv.block_in_shape, 48, seed=48)
    x = [torch.as_tensor(v, dtype=torch.int64, device=dev) for v in (xr, xi)]
    chain = PreparedChain(x[0].shape, x[0].dtype, x[0].device, inv.passes())
    assert chain.products == ("limb64", "limb64")
    got = chain(*x)
    want = x
    for c, kw in inv.passes():
        one = fused_pass(*want, c, **kw)
        want = fused_pass_reference(*want, c, **kw)
        assert torch.equal(one[0], want[0]) and torch.equal(one[1], want[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_limb_pass_at_64_bits_on_card(dev, inverse):
    """The exact int64 form at the widest a pass takes: 4096 rows unscaled
    from 52 bits (the widest data) with 27-bit twiddles (the largest
    shift, 25) and the epilogue, which wraps to 64 bits.  Item 2's first
    row, which the epilogue multiplies, passes 2^62: forward its sum, 4096
    (2^51 - 1) = 2^63 - 4096, a datum whose low word has its top bit set
    under a high word of 2^31 - 1; inverse a little less (each stage
    multiplies it by conj W^0 = (2^25 - 1) / 2^25).  Equal to the plain
    version."""
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain

    r, c = 4096, 6
    cfg = FFTConfig(n=r, mode="unscaled", data_width=52, twiddle_width=27)
    assert (cfg.output_width, cfg.twiddle_shift) == (64, 25)
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    e = tuple(torch.as_tensor(t, device=dev) for t in circle_table(
        dataclasses.replace(cfg, n=r * 64), r, c, inverse, "natural"))
    xr, xi = _limb_items((4, r, c), 52, seed=64)
    x = [torch.as_tensor(v, dtype=torch.int64, device=dev) for v in (xr, xi)]
    top = fused_pass_reference(*x, cfg, tables, transpose_out=False,
                               inverse=inverse, out_dtype=torch.int64)
    assert (top[0][2, 0] > 1 << 62).all()
    assert inverse or (top[0][2, 0] == (1 << 63) - r).all()
    kw = dict(tables=tables, epi=e, transpose_out=True, inverse=inverse,
              out_dtype=torch.int64)
    chain = PreparedChain(x[0].shape, x[0].dtype, x[0].device, [(cfg, kw)])
    assert chain.products == ("limb64",)
    got = chain(*x)
    want = fused_pass_reference(*x, cfg, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _core_frames(batch):
    """Full-scale adversarial int16 frames of the 64k core: frame 0 holds
    INT16_MAX in its first half and INT16_MIN in its second (imaginary
    the other way), so that the first stage's butterflies meet (max, min)
    and the round mode's difference wraps; frame 1 is INT16_MIN
    throughout; the others are uniform over the 16 bits."""
    lo, hi = -(1 << 15), (1 << 15) - 1
    xr, xi = _stimulus((batch, 1 << 16), 16, seed=batch + 16)
    half = 1 << 15
    xr[0, :half], xr[0, half:] = hi, lo
    xi[0, :half], xi[0, half:] = lo, hi
    xr[1], xi[1] = lo, lo
    return xr, xi


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_core_chain_both_forms_on_card(dev, monkeypatch, inverse):
    """The core's 64k transform (scaled, round-half-up, 16-bit data and
    twiddles: 31 bits kept) on full-scale adversarial frames: the chain
    takes the modular form modulo 2^32 in both passes, per pass equal to
    the plain version, the transform equal to golden four_step_int, and
    equal to the same passes forced to the exact form."""
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain

    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, inverse=inverse, order="raw", device=dev)
    xr, xi = _core_frames(4)
    x = [torch.as_tensor(v, dtype=torch.int16, device=dev).reshape(
        (4,) + plan.block_in_shape) for v in (xr, xi)]
    key = (x[0].shape, x[0].dtype, x[0].device)
    chain = PreparedChain(*key, plan.passes())
    assert chain.products == ("mod32", "mod32")
    got = chain(*x)
    want = x
    for c, kw in plan.passes():
        one = fused_pass(*want, c, **kw)
        want = fused_pass_reference(*want, c, **kw)
        assert torch.equal(one[0], want[0]) and torch.equal(one[1], want[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if not inverse:
        gr, gi = four_step_int(xr, xi, cfg, plan.n1, plan.n2)
        o = plan.raw_spectrum_order()
        np.testing.assert_array_equal(got[0].cpu().numpy().reshape(4, -1),
                                      gr[:, o])
        np.testing.assert_array_equal(got[1].cpu().numpy().reshape(4, -1),
                                      gi[:, o])
    _forced(monkeypatch)
    exact = PreparedChain(*key, plan.passes())
    assert exact.products == ("int32", "int32")
    ex = exact(*x)
    assert torch.equal(ex[0], got[0]) and torch.equal(ex[1], got[1])


@pytest.mark.parametrize("rounding", ["round", "truncate"])
@pytest.mark.parametrize("dw,form", [(49, "mod64"), (50, "limb64"),
                                     (17, "mod32"), (18, "int32")],
                         ids=["49-mod64", "50-int128", "17-mod32", "18-int32"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_pass_at_the_bound_on_card(dev, dw, form, inverse, rounding):
    """A pass of 256 rows, scaled at dw bits with 16-bit twiddles and the
    epilogue, int64 -> int64 on the int64 tile and int32 -> int32 on the
    int32 tile: at s + w = 64 (32) it takes the modular form, at 65 (33)
    the exact one, each equal to the plain version on full-scale data."""
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain

    dtype = torch.int64 if dw > 32 else torch.int32
    cfg = FFTConfig(n=256, mode="scaled", rounding=rounding, data_width=dw,
                    twiddle_width=16)
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    e = tuple(torch.as_tensor(t, device=dev) for t in circle_table(
        dataclasses.replace(cfg, n=256 * 64), 256, 40, inverse, "natural"))
    xr, xi = _stimulus((3, 256, 40), dw, seed=dw)
    x = [torch.as_tensor(v, dtype=dtype, device=dev) for v in (xr, xi)]
    kw = dict(tables=tables, epi=e, transpose_out=True, inverse=inverse,
              out_dtype=dtype)
    chain = PreparedChain(x[0].shape, x[0].dtype, x[0].device,
                          [(cfg, kw)])
    assert chain.products == (form,)
    got = chain(*x)
    want = fused_pass_reference(*x, cfg, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dw,form", [(9, "mod32"), (10, "int32")])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_2d_pass_at_the_bound_on_card(dev, dw, form, inverse):
    """An unscaled 256-row pass with the 2-D stage tables (every order
    multiplies) on the int32 tile: the forward's widest product at dw + 8
    bits (32 with the shift at dw = 9, modular; 33 at 10, exact), the
    inverse's at dw + 7 (modular at both); equal to the plain version on
    full-scale data."""
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain

    cfg = FFTConfig(n=256, mode="unscaled", data_width=dw, twiddle_width=16)
    t2 = tuple(torch.as_tensor(t).contiguous().to(dev)
               for t in pack_tables_2d(FFTConfig(n=256 * 64), 256, 64))
    xr, xi = _stimulus((3, 256, 64), dw, seed=dw + 2)
    x = [torch.as_tensor(v, dtype=torch.int32, device=dev) for v in (xr, xi)]
    kw = dict(tables=None, tables_2d=t2, transpose_out=False,
              inverse=inverse, out_dtype=torch.int32)
    chain = PreparedChain(x[0].shape, x[0].dtype, x[0].device,
                          [(cfg, kw)])
    assert chain.products == ("mod32" if inverse else form,)
    got = chain(*x)
    want = fused_pass_reference(*x, cfg, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_prepare_refuses_modular_past_the_bound(dev):
    """intfft_prepare_pass takes the modular form where every product
    keeps bits that fit the tile's word, 64 or 32, and refuses it
    (cudaErrorInvalidValue, nothing clamped, no fallback) past that."""
    import ctypes

    from intfftk_tpu_torch.ops import _build

    lib = _build.library()
    device = torch.cuda.current_device()
    desc = (ctypes.c_uint64 * (lib.intfft_prepared_size() // 8))()
    report = (ctypes.c_int * 5)()

    def prepare(dw, out_size, product, inverse=1, tables=1 | 4, scale=1):
        # [2, 256, 40], truncating, 16-bit twiddles (shift 15), TC 16 of
        # 256 threads
        return lib.intfft_prepare_pass(
            2, 256, 40, out_size, out_size, dw, scale, 0, 15, 0, inverse, 1,
            0, 1, 0, 0, 0, 0, 16, 256, product, 0, 0, 0, 0, tables, device,
            desc, report)

    assert prepare(49, 8, 1) == 0 and prepare(49, 8, 0) == 0
    assert prepare(50, 8, 1) == 1 and prepare(50, 8, 0) == 0
    # the int32 tile: scaled 17 + 15 = 32 modular, 18 + 15 = 33 exact only
    assert prepare(16, 4, 1) == 0 and prepare(16, 4, 0) == 0
    assert prepare(17, 4, 1) == 0 and prepare(16, 2, 1) == 0
    assert prepare(18, 4, 1) == 1 and prepare(18, 4, 0) == 0
    assert prepare(49, 8, 2) == 1 and prepare(17, 4, 2) == 1
    # unscaled forward on the int32 tile: 1-D to order 2 (dw + 6), the
    # epilogue (dw + 8), the 2-D tables to order 0 (dw + 8)
    fwd = dict(inverse=0, scale=0)
    assert prepare(11, 4, 1, tables=1, **fwd) == 0
    assert prepare(12, 4, 1, tables=1, **fwd) == 1
    assert prepare(9, 4, 1, tables=1 | 4, **fwd) == 0
    assert prepare(10, 4, 1, tables=1 | 4, **fwd) == 1
    assert prepare(9, 4, 1, tables=2, **fwd) == 0
    assert prepare(10, 4, 1, tables=2, **fwd) == 1
    assert prepare(10, 4, 0, tables=2, **fwd) == 0
    # unscaled 256 rows at 42 bits in: the inverse's widest product is
    # order 7's 49 bits, the epilogue's 50
    assert lib.intfft_prepare_pass(
        2, 256, 40, 8, 8, 42, 0, 0, 15, 0, 1, 1, 0, 1, 0, 0, 0, 0, 16, 256,
        1, 0, 0, 0, 0, 1, device, desc, report) == 0
    assert lib.intfft_prepare_pass(
        2, 256, 40, 8, 8, 42, 0, 0, 15, 0, 1, 1, 0, 1, 0, 0, 0, 0, 16, 256,
        1, 0, 0, 0, 0, 1 | 4, device, desc, report) == 1


@pytest.mark.parametrize("out_size", [8, 4], ids=["int64", "int32"])
def test_prepare_refuses_limbs_past_their_shift(dev, out_size):
    """The int64 tile's exact form, the limbs, takes a twiddle shift of 0
    to 32 (2^s divides 2^32); intfft_prepare_pass refuses 33 and a
    negative shift (cudaErrorInvalidValue, nothing clamped).  The int32
    tile's exact form, whose product-sums are one 64-bit word, is not held
    to that limit."""
    import ctypes

    from intfftk_tpu_torch.ops import _build

    lib = _build.library()
    device = torch.cuda.current_device()
    desc = (ctypes.c_uint64 * (lib.intfft_prepared_size() // 8))()
    report = (ctypes.c_int * 5)()

    def prepare(shift):
        # [2, 256, 40] scaled at 8 bits, exact products, TC 16 of 256
        # threads
        return lib.intfft_prepare_pass(
            2, 256, 40, out_size, out_size, 8, 1, 0, shift, 0, 1, 1, 0, 1,
            0, 0, 0, 0, 16, 256, 0, 0, 0, 0, 0, 1 | 4, device, desc, report)

    assert prepare(0) == 0 and prepare(25) == 0 and prepare(32) == 0
    if out_size == 8:
        assert prepare(33) == 1 and prepare(-1) == 1
    else:
        assert prepare(33) == 0


@pytest.mark.parametrize("case", ["conv4_inverse", "core_fwd", "core_inv"])
def test_product_form_registers_on_card(dev, case):
    """The two forms of a pass at its geometry, as the library reports
    them: config 4's inverse on the int64 tile, the core's 64k forward and
    inverse passes on the int32 tile (int16 blocks, 256 rows).  On the
    int32 tile the modular kernel takes no more registers and no more local
    memory than the exact one, and the forward, at its cap of 64
    registers, no local memory at all (the inverse's 16-byte stack frame
    at 128 threads is both forms'); on the int64 tile both forms, the
    exact one in limbs, fit the cap of 128 registers with no local
    memory."""
    import ctypes

    from intfftk_tpu_torch.ops import _build

    if case == "conv4_inverse":
        _, _, conv = _conv4(dev)
        g, size, inverse = conv.pair.inv.pass_geometry[0], 8, 1
    else:
        plan = LargeFFTPlan(FFTConfig(n=1 << 16, mode="scaled",
                                      rounding="round", data_width=16,
                                      twiddle_width=16),
                            inverse=case == "core_inv", device=dev)
        g, size, inverse = plan.pass_geometry[0], 2, int(plan.inverse)
    lib = _build.library()
    read = {}
    for product in (0, 1):
        out = (ctypes.c_int * 5)()
        assert lib.intfft_pass_attributes(
            size, size, inverse, 0, 256, g["lane_tile"], g["threads"], 0,
            product, 0, 0, torch.cuda.current_device(), out) == 0
        read[product] = tuple(out)
    if case == "conv4_inverse":
        assert max(read[0][0], read[1][0]) <= 128, read
        assert read[0][1] == read[1][1] == 0, read
    else:
        assert read[1][0] <= read[0][0] and read[1][1] <= read[0][1], read
    if case == "core_fwd":
        assert read[1][1] == 0, read


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


@pytest.mark.parametrize("k", [0, 1, 5, 7, 15, 16, 17, 64, 256])
@pytest.mark.parametrize("body", pv.INT16_BODIES)
def test_probe_chain_int16_on_card(dev, body, k):
    """K9: the packed int16 add chain (two values a register) and the
    unpacked reading, the wrap-around corners among the inputs."""
    n = 4 * pv.cta_elems()
    x = torch.randint(-(1 << 15), 1 << 15, (n,), dtype=torch.int16,
                      device=dev, generator=torch.Generator(
                          device=dev).manual_seed(k))
    x[:4] = torch.tensor([-32768, 32767, -1, 0], dtype=torch.int16)
    before = (pv.probe_chain.launches_int16, pv.probe_chain.launches_add16)
    y = pv.probe_chain(body, x, k)
    torch.cuda.synchronize()
    assert (pv.probe_chain.launches_int16, pv.probe_chain.launches_add16) \
        == (before[0] + 1, before[1] + (body == "add"))
    assert torch.equal(y, pv.chain_reference(body, x, k))


def test_packed_chain_reading_on_card(dev):
    """One quick reading of K9's packed chain passes both guards."""
    r = pv.chain_ops_per_s("add", target_ms=pv.TARGET_MS_QUICK,
                           x=pv.chain_input(torch.int16, dev))
    pv.check_reading(r, pv.lane_rate_peak(dev))
    assert r.dtype == torch.int16 and r.ops_per_s > 0


def test_packed_chain_sass_on_card(dev):
    """K9's loop as compiled: three chains of four on VIADD.16x2, the
    fourth on the funnel shift and the mask, the loop's own counter,
    compare and branch, and no load or store; the all-VIADD.16x2 reading's
    loop one VIADD.16x2 per chain."""
    sass = audit_sass.library_sass()
    k9 = audit_sass.loop_opcodes(audit_sass.chain_function(
        "add", sass, int16=True))
    chains = audit_sass.chains_per_thread("add", int16=True)
    assert k9.get("VIADD.16x2") == 3 * chains // 4
    assert sum(n for op, n in k9.items() if op.startswith("SHF")) == (
        chains // 4)
    assert audit_sass.audit_probe_chain(
        "add", sass, int16=True).total("memory") == 0
    vadd2 = audit_sass.loop_opcodes(audit_sass.chain_function(
        "add_vadd2", sass, int16=True))
    assert vadd2.get("VIADD.16x2") == chains


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
        pv.probe_chain("add", torch.zeros(
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
    """K10 on the tallest tile, [4096, TC] at both geometries and layouts:
    ``TALL_STEPS`` equal to their plain versions in both configs."""
    for geometry in ps.GEOMETRIES:
        for layout in ps.LAYOUTS:
            worst = ps.bit_checks(dev, ps.TALL_ROWS, ps.TALL_STEPS, geometry,
                                  layout)
            assert set(worst) == set(ps.TALL_STEPS)
            assert max(worst.values()) == 0


@pytest.mark.parametrize("layout", ps.LAYOUTS)
@pytest.mark.parametrize("geometry", ps.GEOMETRIES)
@pytest.mark.parametrize("config", [ps.check_config, ps.probe_config],
                         ids=["unscaled", "scaled_round"])
@pytest.mark.parametrize("step", list(ps.STEPS))
def test_stage_step_on_card(dev, step, config, geometry, layout):
    """K10: the once and the loop kernel of every step equal to its plain
    version, and a variant to its production step, with full-scale columns,
    on live unscaled data and on the scaled/round config the tool times (so
    a fixed-mode step's kernel of either mode is compared); two CTAs, at
    both geometries and on both layouts of the tile."""
    cfg = config()
    s = ps.STEPS[step]
    at = dict(geometry=geometry, layout=layout)
    tc, threads, _ = ps.tile_geometry(step, cfg.n, dev, **at)
    assert (tc, threads) == ps.launch_geometry(
        step, cfg.n, geometry, device_tuning(dev))
    dt = torch.int64 if s.wide else torch.int32
    xr, xi = (torch.as_tensor(v).to(dt).to(dev)
              for v in _stimulus((cfg.n, 2 * tc), 16, seed=s.order + 1))
    tables = ps.stage_tables(cfg, dev)
    epi = ps.epilogue_table(cfg, tc, dev)
    for once, k in ((True, 1), (False, 1), (False, ps.check_k(step, cfg))):
        before = ps.stage_loop.launches
        got = ps.stage_loop(step, xr, xi, k, cfg, tables, epi, once=once,
                            **at)
        torch.cuda.synchronize()
        assert ps.stage_loop.launches == before + 1
        want = ps.stage_loop_reference(step, xr, xi, k, cfg, tables, epi)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if s.variant_of:
            prod = ps.stage_loop(s.variant_of, xr, xi, k, cfg, tables, epi,
                                 once=once, **at)
            assert torch.equal(got[0], prod[0])
            assert torch.equal(got[1], prod[1])
    with pytest.raises(ValueError, match="multiple of"):
        ps.stage_loop(step, xr[:, :tc - 1].contiguous(),
                      xi[:, :tc - 1].contiguous(), 1, cfg, tables, epi, **at)


def test_stage_probe_tile_and_refusals_on_card(dev):
    """The library's map of the tile (``intfft_stage_probe_tile``) equals
    the model's ``tile_offset`` on both layouts over the swizzle's range;
    the library refuses a thread count it holds no kernel for (1024) and a
    swizzled TC outside the range, never clamping."""
    import ctypes
    from intfftk_tpu_torch.ops import _build
    for layout in ps.LAYOUTS:
        for wide, tcs in ((False, (4, 8, 16, 32)), (True, (2, 4, 8, 16))):
            for tc in tcs:
                for rows in (8, 256, 4096):
                    assert ps.library_tile(layout, rows, tc, wide) == [
                        ps.tile_offset(layout, r, c, tc, wide)
                        for r in range(rows) for c in range(tc)]
    lib = _build.library()
    ctas = ctypes.c_int(0)
    s = ps.STEPS["prod_p7"]
    assert lib.intfft_stage_probe_geometry(
        s.index, s.order, 0, 256, 8, 128, 1, dev.index or 0,
        ctypes.byref(ctas)) == 0 and ctas.value > 0
    for tc, threads, layout in ((8, 1024, 0), (2, 128, 1), (64, 128, 1)):
        assert lib.intfft_stage_probe_geometry(
            s.index, s.order, 0, 256, tc, threads, layout, dev.index or 0,
            ctypes.byref(ctas)) != 0, (tc, threads, layout)


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


# ---- the launch geometry of the tuning layer (ops/tuning.py)

SWEEP_TILES = [(m, wide) for m in (256, 1024, 4096) for wide in (False, True)]


@pytest.mark.parametrize("lane_tile", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
@pytest.mark.parametrize("m,wide", SWEEP_TILES,
                         ids=[f"m{m}_{'int64' if w else 'int32'}"
                              for m, w in SWEEP_TILES])
def test_sweep_grid_point_vs_plain(dev, m, wide, threads, lane_tile):
    """Every point of the sweep's grid (threads per CTA x lane_tile x the
    budgets of 1-4 CTAs per SM, at m = 256, 1024, 4096 on both tiles)
    through fused_pass against its plain version
    (``sweep_tuning.check_geometry``: both directions, a tail tile, the
    turned load and the turned store, the table epilogue, and on the int32
    tile the in-kernel epilogue; full-scale adversarial items), each launch
    reporting the geometry it was given."""
    from intfftk_tpu_torch.tools import sweep_tuning as st

    geo = [g for g, points in st.grid_geometries(m, wide).items()
           if any(p[:2] == (threads, lane_tile) for p in points)]
    assert geo
    for t, tc in geo:
        assert st.check_geometry(dev, m, wide, tc, t) == 0, (t, tc)


def _raw_pass(lib, x, y, tables, rows, cols, tc, threads, dev):
    """intfft_fused_pass called directly: a forward natural int32 pass of
    [1, rows, cols], no epilogue.  Returns (error, launches made)."""
    import ctypes

    out = (ctypes.c_int * 6)()
    err = lib.intfft_fused_pass(
        x[0].data_ptr(), x[1].data_ptr(), y[0].data_ptr(), y[1].data_ptr(),
        tables[0].data_ptr(), tables[1].data_ptr(), None, None, None, None,
        None, None, 1, rows, cols, 4, 4, 16, 0, 0, 15, 0, 0, 1, 0, 0,
        0, 0, 0, 0, tc, threads, 0, 0, 0, 0, 0, torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream, out)
    torch.cuda.synchronize()
    return err, out[0]


def test_c_entry_refuses_bad_geometry(dev):
    """The C entry refuses a TC that is no power of two, a tile larger than
    the card's shared memory per CTA and a thread count the library holds
    no kernel for, launching nothing: it never clamps, and nothing falls
    back to the plain version."""
    from intfftk_tpu_torch.ops import _build

    for m, tc in ((256, 3), (256, 12), (4096, 16), (4096, 0)):
        cfg = FFTConfig(n=m, mode="unscaled", data_width=16)
        tables = tuple(torch.as_tensor(t, device=dev)
                       for t in pack_tables(cfg))
        x = [torch.zeros((1, m, 40), dtype=torch.int32, device=dev)
             for _ in range(2)]
        before = fused_pass.launches
        with pytest.raises(RuntimeError, match="invalid argument"):
            fused_pass(*x, cfg, tables, transpose_out=False, lane_tile=tc,
                       threads=256)
        assert fused_pass.launches == before
    lib = _build.library()
    cfg = FFTConfig(n=256, mode="unscaled", data_width=16)
    tables = tuple(torch.as_tensor(t, device=dev) for t in pack_tables(cfg))
    x = [torch.ones((1, 256, 40), dtype=torch.int32, device=dev)
         for _ in range(2)]
    y = [torch.full_like(x[0], 7) for _ in range(2)]
    absent = [t for t in (96, 128, 512, 1024) if t not in _build.PASS_THREADS]
    for threads in absent:
        assert _raw_pass(lib, x, y, tables, 256, 40, 16, threads,
                         dev) == (1, 0)
    assert _raw_pass(lib, x, y, tables, 256, 40, 32, 256, dev)[0] == 0
    assert not torch.equal(y[0], torch.full_like(y[0], 7))


def test_smaller_tile_after_larger(dev):
    """One instantiation's shared-memory grant is raised only when a launch
    needs more than any before it: a smaller tile after a larger one, and
    the larger again, each equal to the plain version."""
    for m, tc in ((1024, 16), (256, 2), (1024, 16), (4096, 4), (8, 1)):
        cfg = FFTConfig(n=m, mode="scaled", rounding="round", data_width=16,
                        twiddle_width=16)
        tables = tuple(torch.as_tensor(t, device=dev)
                       for t in pack_tables(cfg))
        xr, xi = _stimulus((2, m, 3 * tc + 1), 16, seed=m + tc)
        x = [torch.as_tensor(v, dtype=torch.int16, device=dev)
             for v in (xr, xi)]
        got = fused_pass(*x, cfg, tables, transpose_out=True, lane_tile=tc,
                         threads=256)
        want = fused_pass_reference(*x, cfg, tables, transpose_out=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_device_row_and_override_on_card(dev):
    """On the H100 the plans resolve the measured "sm_90" row; a plan's
    lane_tile= override changes the geometry the C entry reports and no
    bit."""
    from intfftk_tpu_torch.ops.tuning import TUNINGS, device_tuning

    row = device_tuning(dev)
    assert row is TUNINGS["sm_90"] and row.measured
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    xr, xi = _stimulus((4, 1 << 16), 16, seed=61)
    x = [torch.as_tensor(v, device=dev) for v in (xr, xi)]
    base = LargeFFTPlan(cfg, device=dev)
    over = LargeFFTPlan(cfg, device=dev, lane_tile=2)
    assert base.tuning is row and over.pass_geometry[1]["lane_tile"] == 2
    want = base(*x)
    assert fused_pass.geometry[0] == base.pass_geometry[1]["lane_tile"]
    got = over(*x)
    assert fused_pass.geometry[:2] == (2, over.pass_geometry[1]["threads"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    c = FFTConfig(n=4096, mode="unscaled", data_width=32)
    xw = [torch.as_tensor(v.T.copy(), device=dev)
          for v in _stimulus((40, 4096), 32, seed=62)]
    wide = PallasWideFFTPlan(c, device=dev)
    w0 = wide(*xw)
    assert fused_pass.geometry[:2] == (wide.geometry["lane_tile"],
                                       wide.geometry["threads"])
    w1 = PallasWideFFTPlan(c, device=dev, lane_tile=1)(*xw)
    assert fused_pass.geometry[0] == 1
    assert torch.equal(w0[0], w1[0]) and torch.equal(w0[1], w1[1])


# ---- the submission layer: prepared chains and captured calls

def _headline(dev):
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    return LargeFFTPlan(cfg, device=dev)


def _on(dev, plan, batch, seed, w=16):
    xr, xi = _stimulus((batch,) + plan.block_in_shape, w, seed)
    return [torch.as_tensor(v).to(plan.in_dtype).to(dev) for v in (xr, xi)]


def test_chain_equals_per_pass_on_card(dev):
    """The prepared chain (one C call, both passes) is bit-equal to the
    per-pass fused_pass path at the 64k path's [64, 256, 256] int16 blocks
    and across the 65 535-item loop at batch 65 536 (n = 64 = 8 x 8: two
    launches per pass), with the same launches."""
    for plan, batch in ((_headline(dev), 64),
                        (LargeFFTPlan(FFTConfig(n=64, mode="scaled",
                                                rounding="round"), 8, 8,
                                      device=dev), 65536)):
        x = _on(dev, plan, batch, seed=batch)
        before = fused_pass.launches
        want = plan.apply_blocks(*x, pass_fn=fused_pass)
        per_pass = fused_pass.launches - before
        got = plan.apply_blocks(*x)
        torch.cuda.synchronize()
        assert fused_pass.launches - before == 2 * per_pass
        assert per_pass == (2 if batch < 65536 else 4)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_chain_refuses_foreign_descriptor(dev):
    """intfft_fused_chain launches nothing for a descriptor that was not
    prepared, or was prepared for another device than the one named."""
    import ctypes

    from intfftk_tpu_torch.ops import _build
    from intfftk_tpu_torch.ops.fused_fft import PreparedChain

    plan = _headline(dev)
    x = _on(dev, plan, 2, seed=3)
    chain = PreparedChain(x[0].shape, x[0].dtype, x[0].device, plan.passes())
    lib, _, descs, ptrs, n = chain.runs[0]
    out = (ctypes.c_int * 1)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    blank = (ctypes.c_uint64 * (len(descs)))()
    for d, device in ((blank, x[0].device.index),
                      (descs, x[0].device.index + 1)):
        assert lib.intfft_fused_chain(d, n, ptrs, device, stream, out) == 1
        assert out[0] == 0
    y = chain(*x)
    torch.cuda.synchronize()
    want = plan.apply_blocks(*x, pass_fn=fused_pass)
    assert torch.equal(y[0], want[0]) and torch.equal(y[1], want[1])


def _captured_paths(dev):
    """name -> (the callable, a function of a seed giving its inputs):
    the paths whose host time paced them, at small batches."""
    from intfftk_tpu_torch.ops.intmath import spectrum_product as prod

    head = _headline(dev)
    cfg = head.cfg
    fwd = LargeFFTPlan(cfg, order="raw", device=dev)
    inv = LargeFFTPlan(dataclasses.replace(cfg, data_width=cfg.output_width),
                       fwd.n2, fwd.n1, inverse=True, order="raw", device=dev)
    c2 = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                   twiddle_width=20)
    f2 = LargeFFTPlan(c2, order="raw", device=dev)
    i2 = LargeFFTPlan(dataclasses.replace(c2, mode="scaled", rounding="round",
                                          data_width=c2.output_width),
                      f2.n2, f2.n1, inverse=True, order="raw", device=dev)
    h1 = torch.full(f2.block_out_shape, 1 << 23, dtype=torch.int32,
                    device=dev)
    h0 = torch.zeros_like(h1)
    mono = LargeFFTPlan(FFTConfig(n=1 << 19, mode="scaled", rounding="round",
                                  data_width=16, twiddle_width=16),
                        schedule="monolithic", device=dev)
    spec = make_conv_spec(n=1 << 16, taps_len=(1 << 13) + 1,
                          twiddle_width=16, max_product_width=44,
                          max_spectrum_width=25)
    rng = np.random.default_rng(1)
    conv = OverlapSaveConv(spec, rng.integers(-(1 << 13), 1 << 13, 8193),
                           np.zeros(8193, np.int64), device=dev)
    pc = head.passes()[0]
    sp = PallasFFTPlan(FFTConfig(n=1024, mode="scaled", rounding="round"),
                       layout="bn", device=dev)
    return {
        "one pass": (lambda a, b: fused_pass(a, b, pc[0], **pc[1]),
                     lambda s: _on(dev, head, 4, s)),
        "headline": (head.capture(), lambda s: _on(dev, head, 8, s)),
        "roundtrip": (lambda a, b: inv.apply_blocks(*fwd.apply_blocks(a, b)),
                      lambda s: _on(dev, fwd, 8, s)),
        "config 2": (lambda a, b: i2.apply_blocks(*prod(
            *f2.apply_blocks(a, b), h1, h0, 23, 48, 25, torch.int64)),
            lambda s: _on(dev, f2, 2, s, w=28)),
        "monolithic 512K": (mono.capture(), lambda s: _on(dev, mono, 2, s)),
        "config 4": (conv.capture(), lambda s: [
            torch.as_tensor(v, dtype=torch.int32, device=dev)
            for v in _stimulus((2, 2 * spec.payload), 14, s)]),
        "single pass": (sp.capture(), lambda s: [
            torch.as_tensor(v, dtype=torch.int32, device=dev)
            for v in _stimulus((40, 1024), 16, s)]),
    }


def _flat(y):
    return [t for v in y for t in (_flat(v) if isinstance(v, tuple)
                                   else [v])]


CAPTURED = ["one pass", "headline", "roundtrip", "config 2",
            "monolithic 512K", "config 4", "single pass"]


@pytest.mark.parametrize("name", CAPTURED)
def test_captured_replay_on_card(dev, name):
    """A captured path replays bit-equal to its eager call, with the eager
    call's launches counted on each replay; a replay after the input
    changes gives the new result; another batch captures again; and each
    call overwrites the previous call's outputs (they are static)."""
    from intfftk_tpu_torch.ops.intmath import spectrum_product as prod
    from intfftk_tpu_torch.runtime import CapturedCall, captured

    fn, inputs = _captured_paths(dev)[name]
    call = fn if isinstance(fn, CapturedCall) else captured(fn)
    eager = call.fn
    x1, x2 = inputs(1), inputs(2)
    counts = lambda: (fused_pass.launches, prod.launches)
    c0 = counts()
    want1 = [t.clone() for t in _flat(eager(*x1))]
    c1 = counts()
    per_call = (c1[0] - c0[0], c1[1] - c0[1])
    got = call(*x1)                       # warm-up, capture, replay
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), want1))
    c2 = counts()
    got2 = call(*x2)
    torch.cuda.synchronize()
    assert (counts()[0] - c2[0], counts()[1] - c2[1]) == per_call
    want2 = _flat(eager(*x2))
    assert all(torch.equal(a, b) for a, b in zip(_flat(got2), want2))
    assert all(a is b for a, b in zip(_flat(got), _flat(got2)))
    assert not all(torch.equal(a, b) for a, b in zip(_flat(got), want1))
    s = call.static_inputs(*x1)
    for t, v in zip(s, x1):
        t.copy_(v)
    again = call(*s)                      # the static inputs: no copy
    assert all(torch.equal(a, b) for a, b in zip(_flat(again), want1))
    if name in ("headline", "single pass"):
        x3 = [torch.cat([v, v[:1]]) for v in x1]     # another batch
        got3 = call(*x3)
        assert len(call._graphs) == 2
        want3 = _flat(eager(*x3))
        assert all(torch.equal(a, b) for a, b in zip(_flat(got3), want3))


def test_captured_interleaved_and_retuned_on_card(dev):
    """Two captured calls interleaved keep their own graphs and outputs;
    retune drops a plan's graphs and the next call captures the new
    geometry, with the same bits."""
    from intfftk_tpu_torch.ops.tuning import TUNINGS

    a = _headline(dev)
    b = LargeFFTPlan(a.cfg, order="raw", device=dev)
    ca, cb = a.capture(), b.capture()
    xa, xb = _on(dev, a, 4, 5), _on(dev, b, 4, 6)
    wa, wb = a.apply_blocks(*xa), b.apply_blocks(*xb)
    for _ in range(2):
        ya, yb = ca(*xa), cb(*xb)
        assert torch.equal(ya[0], wa[0]) and torch.equal(yb[1], wb[1])
        assert torch.equal(ya[1], wa[1]) and torch.equal(yb[0], wb[0])
    a.retune(TUNINGS["default"])
    assert not ca._graphs and a.pass_geometry[0]["lane_tile"] == 16
    ya = ca(*xa)
    torch.cuda.synchronize()
    assert fused_pass.geometry[:2] == (16, 256)
    assert torch.equal(ya[0], wa[0]) and torch.equal(ya[1], wa[1])


def test_captured_refusals_on_card(dev):
    """A captured call raises on CPU tensors and on a call that
    synchronises with the host inside the capture; nothing runs eagerly in
    its place and no graph is kept."""
    from intfftk_tpu_torch.runtime import captured

    plan = _headline(dev)
    call = plan.capture()
    x = _on(dev, plan, 2, 7)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        call(*(v.cpu() for v in x))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        call(x[0], x[1].cpu())
    bad = captured(lambda u: (u + 1, int(u.sum().item())))
    with pytest.raises(RuntimeError):
        bad(x[0])
    assert not bad._graphs and not call._graphs


@pytest.mark.parametrize("schedule", ["fourstep", "monolithic"])
@pytest.mark.parametrize("inverse,order", [(False, "natural"),
                                           (True, "natural"),
                                           (False, "raw"), (True, "raw")],
                         ids=["fwd", "inv", "fwd_raw", "inv_raw"])
@pytest.mark.parametrize("n,mode,rounding,batch", [
    (1 << 16, "scaled", "round", 3), (1 << 16, "scaled", "round", 4),
    (1 << 16, "unscaled", "truncate", 2), (1 << 12, "unscaled", "truncate", 3),
    (1 << 10, "scaled", "truncate", 5)])
def test_whole_vs_plain_on_card(dev, n, mode, rounding, batch, inverse,
                                order, schedule):
    """The whole four-step's cluster kernel (LargeFFTPlan(fuse="whole"): one
    launch, clusters of 8 CTAs at 64k, of one at 4096 and 1024) ==
    fused_four_step_reference, the two passes' plain versions in turn, at
    int16 and int32 blocks, batch_block 2 on batches it divides and does
    not; its captured replay == the eager call."""
    cfg = FFTConfig(n=n, mode=mode, rounding=rounding, data_width=16,
                    twiddle_width=16)
    n1 = n2 = 1 << ((n.bit_length() - 1) // 2)
    plan = LargeFFTPlan(cfg, n1, n2, inverse, order=order, schedule=schedule,
                        fuse="whole", device=dev)
    xr, xi = _stimulus((batch, n), 16, seed=n + batch)
    x = [torch.as_tensor(v.reshape((batch,) + plan.block_in_shape)).to(
        plan.in_dtype).to(dev) for v in (xr, xi)]
    before = (fused_whole.launches, fused_pass.launches)
    y = plan.apply_blocks(*x)
    torch.cuda.synchronize()
    assert (fused_whole.launches, fused_pass.launches) == (before[0] + 1,
                                                           before[1])
    want = fused_four_step_reference(*x, plan.passes())
    assert all(torch.equal(a, b) for a, b in zip(y, want))
    got = plan.capture()(*x)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, y))


@pytest.mark.parametrize("schedule", ["fourstep", "monolithic"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_whole_bypass_on_card(dev, schedule, inverse):
    """bypass_fly through the cluster kernel (one group of no stage per
    factor: the reorders and the turn alone) == its plain version."""
    cfg = FFTConfig(n=1 << 16, bypass_fly=True)
    plan = LargeFFTPlan(cfg, 256, 256, inverse, schedule=schedule,
                        fuse="whole", device=dev)
    xr, xi = _stimulus((2, 1 << 16), 16, seed=17)
    x = [torch.as_tensor(v.reshape((2,) + plan.block_in_shape)).to(
        plan.in_dtype).to(dev) for v in (xr, xi)]
    y = plan.apply_blocks(*x)
    want = fused_four_step_reference(*x, plan.passes())
    assert all(torch.equal(a, b) for a, b in zip(y, want))


def test_whole_headline_on_card(dev):
    """The 64k headline through fuse="whole" at batch 2: one cluster
    launch, bit-equal to golden four_step_int."""
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, fuse="whole", device=dev)
    assert plan.whole_geometry["cluster"] is None    # the rule's, per batch
    xr, xi = _stimulus((2, 1 << 16), 16, seed=5)
    before = fused_whole.launches
    yr, yi = plan(torch.as_tensor(xr, device=dev),
                  torch.as_tensor(xi, device=dev))
    torch.cuda.synchronize()
    assert fused_whole.launches == before + 1
    assert fused_whole.geometry[0] in (8, 16)
    gr, gi = four_step_int(xr, xi, cfg, 256, 256)
    np.testing.assert_array_equal(yr.cpu().numpy(), gr)
    np.testing.assert_array_equal(yi.cpu().numpy(), gi)


@pytest.mark.parametrize("cluster", [4, 8, 16])
def test_whole_cluster_sizes_on_card(dev, cluster):
    """The headline's two passes through the cluster kernel at clusters of
    4 (one CTA per SM), 8 and 16 CTAs per item (the non-portable size),
    batch_block 2 on a batch of 3: == fused_four_step_reference; the C
    entry reports the cluster."""
    cfg = FFTConfig(n=1 << 16, mode="scaled", rounding="round",
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, fuse="whole", device=dev)
    xr, xi = _stimulus((3, 1 << 16), 16, seed=cluster)
    x = [torch.as_tensor(v.reshape((3,) + plan.block_in_shape)).to(
        plan.in_dtype).to(dev) for v in (xr, xi)]
    y = fused_whole(*x, plan.passes(), cluster=cluster, batch_block=2)
    torch.cuda.synchronize()
    assert fused_whole.geometry[0] == cluster
    want = fused_four_step_reference(*x, plan.passes())
    assert all(torch.equal(a, b) for a, b in zip(y, want))


#: The wide chains of the whole form: (FFTConfig keywords, data width of
#: the stimulus): wide2 (int32 -> int32 -> int64), wide1 (int32 -> int64
#: -> int64, config 2's forward at 32-bit data and 20-bit twiddles) and
#: wide_in (int64 throughout, config 2's scaled/round inverse).
WIDE_WHOLE = {
    "wide2": (dict(mode="unscaled", data_width=24, twiddle_width=16), 24),
    "wide1": (dict(mode="unscaled", data_width=32, twiddle_width=20), 32),
    "wide_in": (dict(mode="scaled", rounding="round", data_width=44,
                     twiddle_width=20), 44)}


@pytest.mark.parametrize("inverse,order", [(False, "natural"),
                                           (True, "natural"),
                                           (False, "raw"), (True, "raw")],
                         ids=["fwd", "inv", "fwd_raw", "inv_raw"])
@pytest.mark.parametrize("n,batch", [(1 << 16, 3), (1 << 12, 3)],
                         ids=["64k", "4096"])
@pytest.mark.parametrize("wide", list(WIDE_WHOLE))
def test_whole_wide_vs_plain_on_card(dev, wide, n, batch, inverse, order):
    """The wide whole forms (an int64 output) through the cluster kernel:
    one launch, == fused_four_step_reference on full-scale stimuli; at 64k
    a cluster of 16 where the receive buffer is int64 (wide1, wide_in), of
    8 under wide2, at 4096 of one; no spill; its captured replay == the
    eager call."""
    kw, w = WIDE_WHOLE[wide]
    cfg = FFTConfig(n=n, **kw)
    n1 = n2 = 1 << ((n.bit_length() - 1) // 2)
    plan = LargeFFTPlan(cfg, n1, n2, inverse, order=order, fuse="whole",
                        device=dev)
    assert plan.out_dtype == torch.int64
    xr, xi = _stimulus((batch, n), w, seed=n + w)
    x = [torch.as_tensor(v.reshape((batch,) + plan.block_in_shape)).to(
        plan.in_dtype).to(dev) for v in (xr, xi)]
    before = (fused_whole.launches, fused_pass.launches)
    y = plan.apply_blocks(*x)
    torch.cuda.synchronize()
    assert (fused_whole.launches, fused_pass.launches) == (before[0] + 1,
                                                           before[1])
    g = fused_whole.geometry
    smallest = whole_cluster(plan.tuning, *plan.block_in_shape,
                             plan.mid_dtype.itemsize, 8)
    assert g[0] >= smallest and (g[1], g[5]) == (256, 1)
    assert smallest == (1 if n < 1 << 16 else 16
                        if plan.mid_dtype == torch.int64 else 8)
    assert g[7] == 0, f"the wide whole kernel spills: {g}"
    want = fused_four_step_reference(*x, plan.passes())
    assert all(torch.equal(a, b) for a, b in zip(y, want))
    got = plan.capture()(*x)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, y))


@pytest.mark.parametrize("cluster", [2, 16])
@pytest.mark.parametrize("wide", list(WIDE_WHOLE))
def test_whole_wide_cluster_sizes_on_card(dev, wide, cluster):
    """The wide forms at other clusters: 16 at 64k (the non-portable size,
    wide2's too) and 2 at 4096, batch_block 2 on a batch of 4: ==
    fused_four_step_reference."""
    kw, w = WIDE_WHOLE[wide]
    n = 1 << 16 if cluster == 16 else 1 << 12
    cfg = FFTConfig(n=n, **kw)
    plan = LargeFFTPlan(cfg, fuse="whole", device=dev)
    xr, xi = _stimulus((4, n), w, seed=cluster)
    x = [torch.as_tensor(v.reshape((4,) + plan.block_in_shape)).to(
        plan.in_dtype).to(dev) for v in (xr, xi)]
    y = fused_whole(*x, plan.passes(), cluster=cluster, batch_block=2)
    torch.cuda.synchronize()
    assert fused_whole.geometry[0] == cluster
    want = fused_four_step_reference(*x, plan.passes())
    assert all(torch.equal(a, b) for a, b in zip(y, want))


def test_whole_wide_refuses_what_does_not_fit(dev):
    """A wide 64k item at a cluster of 4 (266 240 B of int64 tile per CTA)
    fits no CTA: the C entry refuses it (RuntimeError with the CUDA error)
    and nothing runs, no split in its place."""
    kw, w = WIDE_WHOLE["wide1"]
    plan = LargeFFTPlan(FFTConfig(n=1 << 16, **kw), fuse="whole", device=dev)
    x = [torch.zeros((2,) + plan.block_in_shape, dtype=plan.in_dtype,
                     device=dev) for _ in range(2)]
    before = (fused_whole.launches, fused_pass.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_whole(*x, plan.passes(), cluster=4)
    assert (fused_whole.launches, fused_pass.launches) == before


def test_whole_config2_chain_on_card(dev):
    """The config-2 chain at batch 8 through the whole form (the raw
    forward int32 -> int64, the exact-unity spectrum product, the raw
    scaled/round inverse int64): 2 cluster launches and 1 product launch,
    == the split's chain and golden four_step_int."""
    c2 = FFTConfig(n=1 << 16, mode="unscaled", data_width=32,
                   twiddle_width=20)
    c2i = dataclasses.replace(c2, mode="scaled", rounding="round",
                              data_width=c2.output_width)
    plans = {}
    for fuse in ("whole", "split"):
        f = LargeFFTPlan(c2, order="raw", fuse=fuse, device=dev)
        i = LargeFFTPlan(c2i, f.n2, f.n1, True, order="raw", fuse=fuse,
                         device=dev)
        plans[fuse] = (f, i)
    f, i = plans["whole"]
    hr = torch.full(f.block_out_shape, 1 << 23, dtype=torch.int32,
                    device=dev)
    hi = torch.zeros_like(hr)
    xr, xi = _stimulus((8, 1 << 16), 32, seed=2)
    x = [torch.as_tensor(v.reshape((8,) + f.block_in_shape)).to(
        torch.int32).to(dev) for v in (xr, xi)]

    def chain(fuse):
        f, i = plans[fuse]
        y = f.apply_blocks(*x)
        p = spectrum_product(*y, hr, hi, 23, c2.output_width, 25,
                             torch.int64)
        return y, i.apply_blocks(*p)

    before = (fused_whole.launches, fused_pass.launches,
              spectrum_product.launches)
    y, z = chain("whole")
    torch.cuda.synchronize()
    assert (fused_whole.launches - before[0], fused_pass.launches - before[1],
            spectrum_product.launches - before[2]) == (2, 0, 1)
    sy, sz = chain("split")
    assert all(torch.equal(a, b) for a, b in zip(y + z, sy + sz))
    gr, gi = four_step_int(xr, xi, c2, f.n1, f.n2)
    o = f.raw_spectrum_order()
    np.testing.assert_array_equal(y[0].reshape(8, -1).cpu().numpy(),
                                  gr[:, o])
    hr2, hi2 = four_step_int(gr, gi, c2i, i.n1, i.n2, inverse=True)
    np.testing.assert_array_equal(z[0].reshape(8, -1).cpu().numpy(),
                                  np.asarray(hr2).astype(np.int64))
    np.testing.assert_array_equal(z[1].reshape(8, -1).cpu().numpy(),
                                  np.asarray(hi2).astype(np.int64))


@pytest.mark.parametrize("dtype", ["int16", "int32"])
@pytest.mark.parametrize("schedule", ["fourstep", "monolithic"])
@pytest.mark.parametrize("inverse,order", [(False, "natural"),
                                           (True, "natural"),
                                           (False, "raw"), (True, "raw")],
                         ids=["fwd", "inv", "fwd_raw", "inv_raw"])
@pytest.mark.parametrize("batch,batch_block", [(1, 2), (3, 1), (31, 1),
                                               (65, 1), (65, 2)])
def test_whole_persistent_grid_on_card(dev, batch, batch_block, inverse,
                                       order, schedule, dtype):
    """The persistent grid at batches that do not divide the clusters the
    card holds (1, 3, 31, 65 items, in blocks of 1, and 65 in blocks of 2,
    reduced to 1): one launch of as many clusters as the card holds or the
    blocks need (its rounds the blocks of the busiest cluster) ==
    fused_four_step_reference on full-scale adversarial and random
    stimuli, int16 blocks (scaled/round) and int32 ones (unscaled), both
    schedules, directions and orders; the
    captured replay == the eager call, and a replay on new inputs too."""
    mode = ("scaled", "round") if dtype == "int16" else ("unscaled",
                                                         "truncate")
    cfg = FFTConfig(n=1 << 16, mode=mode[0], rounding=mode[1],
                    data_width=16, twiddle_width=16)
    plan = LargeFFTPlan(cfg, 256, 256, inverse, order=order,
                        schedule=schedule, fuse="whole",
                        batch_block=batch_block, device=dev)
    assert plan.in_dtype == getattr(torch, dtype)
    x = [torch.as_tensor(v.reshape((batch,) + plan.block_in_shape)).to(
        plan.in_dtype).to(dev) for v in _stimulus((batch, 1 << 16), 16,
                                                  seed=batch + 7)]
    before = (fused_whole.launches, fused_pass.launches)
    y = plan.apply_blocks(*x)
    torch.cuda.synchronize()
    assert (fused_whole.launches, fused_pass.launches) == (before[0] + 1,
                                                           before[1])
    g = fused_whole.geometry
    blocks = batch // (batch_block if batch % batch_block == 0 else 1)
    assert g[3] == min(g[4], blocks)
    assert g[8] == -(-blocks // g[3])
    # the 128-register shape spills nothing (the 85-register one may)
    assert g[7] == 0 or g[5] == 3, f"the whole kernel spills: {g}"
    want = fused_four_step_reference(*x, plan.passes())
    assert all(torch.equal(a, b) for a, b in zip(y, want))
    call = plan.capture()
    got = call(*x)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, y))
    x2 = [torch.as_tensor(v.reshape((batch,) + plan.block_in_shape)).to(
        plan.in_dtype).to(dev) for v in _stimulus((batch, 1 << 16), 16,
                                                  seed=batch + 8)]
    got = call(*x2)
    torch.cuda.synchronize()
    want = fused_four_step_reference(*x2, plan.passes())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("batch", [1, 31, 65])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("wide", list(WIDE_WHOLE))
def test_whole_wide_persistent_grid_on_card(dev, wide, inverse, batch):
    """The wide chains on the persistent grid at batches that do not divide
    the clusters held: == fused_four_step_reference, no spill."""
    kw, w = WIDE_WHOLE[wide]
    plan = LargeFFTPlan(FFTConfig(n=1 << 16, **kw), None, None, inverse,
                        order="raw", fuse="whole", batch_block=1,
                        device=dev)
    x = [torch.as_tensor(v.reshape((batch,) + plan.block_in_shape)).to(
        plan.in_dtype).to(dev) for v in _stimulus((batch, 1 << 16), w,
                                                  seed=batch + w)]
    y = plan.apply_blocks(*x)
    torch.cuda.synchronize()
    g = fused_whole.geometry
    assert g[3] == min(g[4], batch) and g[8] == -(-batch // g[3])
    assert g[7] == 0, f"the wide whole kernel spills: {g}"
    want = fused_four_step_reference(*x, plan.passes())
    assert all(torch.equal(a, b) for a, b in zip(y, want))
