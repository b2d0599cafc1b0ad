"""The port's twiddle synthesis (intfftk_tpu_torch.ops.twiddle_synth) and
the split pipeline's epilogue modes against the JAX generator, golden
circle_twiddles_int / four_step_int and the JAX split plan (interpret),
exactly.

On the CPU ``device_circle_table`` and the in-kernel epilogue run their
plain version ``synth_circle_block``; the generator kernel and the
in-kernel form are held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden.four_step import four_step_int
from intfftk_tpu.golden.twiddle import circle_twiddles_int
from intfftk_tpu.ops import pallas_fft as jp
from intfftk_tpu.ops import twiddle_synth as js
from intfftk_tpu_torch.convert import config_from_jax as P
from intfftk_tpu_torch.convert import tables_from_jax, unpack_coarse
from intfftk_tpu_torch.ops.fused_fft import (LargeFFTPlan, fused_pass,
                                              fused_pass_reference)
from intfftk_tpu_torch.ops.transform import pack_tables
from intfftk_tpu_torch.ops.twiddle_synth import (EpiSynth, can_synth,
                                                 coarse_table,
                                                 device_circle_table,
                                                 synth_circle_block)

N256K = 1 << 18


def _cfg(n, gen="auto", **kw):
    return FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                     twiddle_width=16, twiddle_gen=gen, **kw)


def _golden_block(n, gen, rows, cols, j0, inverse):
    wc_re, wc_im = circle_twiddles_int(n, 16, gen)
    m = (np.arange(rows)[:, None] * (j0 + np.arange(cols))[None, :]) % n
    if inverse:
        m = (-m) % n
    return wc_re[m], wc_im[m]


@pytest.mark.parametrize("n,gen", [(1 << 18, "auto"), (1 << 20, "auto"),
                                   (1 << 20, "taylor_new")])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_synth_block_bits(n, gen, inverse):
    """synth_circle_block == the JAX one (jitted) == the golden circle
    table, over the plan's whole [n1, n2] block."""
    cfg = _cfg(n, gen)
    L = n.bit_length() - 1
    n2, n1 = 1 << (L // 2), n >> (L // 2)
    er, ei = synth_circle_block(coarse_table(P(cfg)), n1, n2, 0, n, P(cfg),
                                inverse)
    assert er.dtype == torch.int32 and tuple(er.shape) == (n1, n2)
    gr, gi = _golden_block(n, gen, n1, n2, 0, inverse)
    np.testing.assert_array_equal(er.numpy(), gr)
    np.testing.assert_array_equal(ei.numpy(), gi)
    jr, ji = jax.jit(lambda t: js.synth_circle_block(
        t, n1, n2, 0, n, cfg, inverse))(jnp.asarray(js.packed_coarse(cfg)))
    np.testing.assert_array_equal(er.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_synth_block_offset(inverse):
    """A block at column j0 > 0: a 128-column one against the JAX
    generator (whose lane gathers need 128-multiples), and a ragged
    40-column one against golden."""
    n, gen = 1 << 20, "taylor_new"
    cfg = _cfg(n, gen)
    co = coarse_table(P(cfg))
    er, ei = synth_circle_block(co, 1024, 128, 384, n, P(cfg), inverse)
    jr, ji = jax.jit(lambda t: js.synth_circle_block(
        t, 1024, 128, 384, n, cfg, inverse))(
            jnp.asarray(js.packed_coarse(cfg)))
    np.testing.assert_array_equal(er.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))
    er, ei = synth_circle_block(co, 1024, 40, 984, n, P(cfg), inverse)
    gr, gi = _golden_block(n, gen, 1024, 40, 984, inverse)
    np.testing.assert_array_equal(er.numpy(), gr)
    np.testing.assert_array_equal(ei.numpy(), gi)
    with pytest.raises(ValueError):        # k1 * j2 would reach n
        synth_circle_block(co, 1024, 40, 1000, n, P(cfg), inverse)


def test_device_circle_table_matches_jax():
    """The CPU route of device_circle_table == the JAX generator at 512K,
    and counts no generator launch."""
    n, n1, n2 = 1 << 19, 1 << 10, 1 << 9
    cfg = _cfg(n)
    before = device_circle_table.launches
    er, ei = device_circle_table(P(cfg), n, n1, n2, inverse=False, device="cpu")
    assert device_circle_table.launches == before
    jr, ji = js.device_circle_table(cfg, n, n1, n2, inverse=False)
    np.testing.assert_array_equal(er.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))


def test_coarse_table_and_can_synth():
    """The coarse table is the JAX packed table unpacked; can_synth is the
    JAX rule on natural/raw order, ROM twiddles, widths and sizes."""
    cfg = _cfg(1 << 20)
    re, im = unpack_coarse(js.packed_coarse(cfg))
    ours = coarse_table(P(cfg))
    assert torch.equal(ours[0], re) and torch.equal(ours[1], im)
    cases = [_cfg(1 << 20), _cfg(1 << 12), _cfg(1 << 11), _cfg(1 << 20, "rom"),
             FFTConfig(n=1 << 20, twiddle_width=17), _cfg(1 << 16, "taylor_new")]
    for cfg in cases:
        for order in ("natural", "raw"):
            assert can_synth(P(cfg), order) == js.can_synth(cfg, order)
    assert can_synth(P(_cfg(1 << 12)), "natural")
    assert not can_synth(P(_cfg(1 << 11)), "natural")


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_fused_pass_synth_vs_jax(inverse):
    """The in-kernel epilogue form == JAX _FusedPass(epi_synth_n) in
    interpret mode at [3, 64, 128], n = 8192; the wrapper takes the plain
    version on the CPU and counts no launch."""
    n, r, c = 1 << 13, 64, 128
    cfg = _cfg(r)
    rng = np.random.default_rng(3)
    xr, xi = (rng.integers(-(1 << 15), 1 << 15, (3, r, c)) for _ in "ri")
    jpass = jp._FusedPass(cfg, inverse, wide_in=False, wide_out=False,
                          has_epi=True, transpose_out=True, interpret=True,
                          spectrum_rows="natural", epi_synth_n=n)
    (jr,), (ji,) = jpass.apply(jpass.consts, (jnp.asarray(xr, jnp.int32),),
                               (jnp.asarray(xi, jnp.int32),))
    tables = tuple(torch.as_tensor(t) for t in pack_tables(P(cfg)))
    syn = EpiSynth(*coarse_table(P(cfg)), n)
    x = [torch.as_tensor(v).int() for v in (xr, xi)]
    kw = dict(synth=syn, transpose_out=True, inverse=inverse)
    yr, yi = fused_pass_reference(*x, P(cfg), tables, **kw)
    np.testing.assert_array_equal(yr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(ji))
    before = fused_pass.launches
    wr, wi = fused_pass(*x, P(cfg), tables, **kw)
    assert torch.equal(wr, yr) and torch.equal(wi, yi)
    assert fused_pass.launches == before
    with pytest.raises(ValueError):          # synthesis is natural order
        fused_pass(*x, P(cfg), tables, synth=syn, transpose_out=True,
                   natural=False)
    with pytest.raises(ValueError):          # 64 x 128 blocks reach 8192
        fused_pass(*x, P(cfg), tables, synth=EpiSynth(syn.re, syn.im, 4096),
                   transpose_out=True)


@functools.cache
def _jax_256k(inverse):
    """The JAX split plan at 256K (device mode on the CPU tuning) and its
    output on the seeded stimulus, computed once per direction."""
    plan = jp.LargeFFTPlan(_cfg(N256K), inverse=inverse, interpret=True)
    assert not plan.fused_whole and plan.epi_mode == "device"
    xr, xi = _stim256k()
    yr, yi = plan(xr, xi)
    return plan, np.asarray(yr, np.int64), np.asarray(yi, np.int64)


def _stim256k():
    rng = np.random.default_rng(5)
    xr, xi = (rng.integers(-(1 << 15), 1 << 15, (1, N256K)) for _ in "ri")
    xr[0, ::7] = -(1 << 15)
    return xr, xi


@pytest.mark.parametrize("mode", ["auto", "host", "device", "inkernel"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_large_fft_256k_epi_modes(mode, inverse):
    """LargeFFTPlan at 256K in every epilogue mode == golden four_step_int
    == the JAX split plan; "auto" is "device" here, and "inkernel" holds no
    epilogue table."""
    cfg = _cfg(N256K)
    plan = LargeFFTPlan(P(cfg), inverse=inverse, epi_synth=mode, device="cpu")
    jplan, jr, ji = _jax_256k(inverse)
    assert plan.epi_mode == ("device" if mode == "auto" else mode)
    assert (plan.n1, plan.n2, plan.io16) == (jplan.n1, jplan.n2, jplan.io16)
    names = dict(plan.named_buffers())
    assert ("er" in names) == (mode != "inkernel")
    assert ("coarse_re" in names) == (mode == "inkernel")
    xr, xi = _stim256k()
    yr, yi = plan(torch.as_tensor(xr), torch.as_tensor(xi))
    gr, gi = four_step_int(xr, xi, cfg, plan.n1, plan.n2, inverse=inverse)
    np.testing.assert_array_equal(yr.numpy(), gr)
    np.testing.assert_array_equal(yi.numpy(), gi)
    np.testing.assert_array_equal(yr.numpy(), jr)
    np.testing.assert_array_equal(yi.numpy(), ji)


def test_epi_synth_rejects():
    cfg = _cfg(N256K)
    for bad in (dict(epi_synth="device", order="raw"),
                dict(epi_synth="inkernel", order="raw"),
                dict(epi_synth="yes"), dict(epi_synth=True),
                dict(schedule="monolithic", epi_synth="device")):
        with pytest.raises(ValueError):
            LargeFFTPlan(P(cfg), **bad, device="cpu")
    with pytest.raises(ValueError):          # twiddles wider than 16 bits
        LargeFFTPlan(P(FFTConfig(n=N256K, twiddle_width=18)),
                     epi_synth="inkernel", device="cpu")
    for cfg, order in ((FFTConfig(n=N256K, twiddle_width=18), "natural"),
                       (_cfg(N256K, "rom"), "natural"), (cfg, "raw")):
        assert LargeFFTPlan(P(cfg), order=order, device="cpu").epi_mode == "host"


@pytest.mark.parametrize("mode", ["device", "inkernel"])
def test_tables_from_jax_synth_modes(mode, monkeypatch):
    """The JAX split plan's device-mode consts (the generated er/ei) and
    in-kernel consts (the packed coarse table) convert to the port's
    buffers; a plan loaded with them gives the same bits."""
    monkeypatch.setattr(jp, "EPI_SYNTH", mode)
    cfg = _cfg(N256K)
    jplan = jp.LargeFFTPlan(cfg, interpret=True)
    assert jplan.epi_mode == mode
    tables = tables_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jplan.consts))
    plan = LargeFFTPlan(P(cfg), epi_synth=mode, device="cpu")
    assert set(tables) == set(dict(plan.named_buffers()))
    for name, t in tables.items():
        assert torch.equal(getattr(plan, name), t), name
    loaded = LargeFFTPlan(P(cfg), epi_synth=mode, device="cpu")
    for name in tables:
        getattr(loaded, name).zero_()
    loaded.load_tables(tables)
    xr, xi = (torch.as_tensor(v) for v in _stim256k())
    for a, b in zip(plan(xr, xi), loaded(xr, xi)):
        assert torch.equal(a, b)
