"""The port's benchmark (``bench_torch``) on the CPU: every cell's build
function at a tiny size on ``device="cpu"`` (the plain versions) against
the port's golden model and the JAX plan (Pallas in interpret mode) on the
same numpy stimulus, exactly; its work counts against ``utils.roofline``;
its SNR helper against the JAX package's; the bit-check families' names; the
timing functions refusing the CPU; and ``python -m bench_torch --smoke``.

Nothing here decides at import time whether there is a card: the timing
tests set what ``torch.cuda.is_available`` answers themselves."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import cpu_mesh
from intfftk_tpu.config import FFTConfig as JaxConfig
from intfftk_tpu.config import snr_db as jax_snr_db
from intfftk_tpu.golden import make_conv_spec as jax_conv_spec
from intfftk_tpu.ops import pallas_fft as jp
from intfftk_tpu.parallel.channelizer import Channelizer as JaxChannelizer
from intfftk_tpu.parallel.convolve import OverlapSaveConv as JaxConv
from intfftk_tpu_torch.config import snr_db
from intfftk_tpu_torch.utils.roofline import fft_cost, large_fft_cost

from bench_torch import __main__ as bench_main
from bench_torch import cells, count, timing, verify

REPO = Path(__file__).resolve().parent.parent

#: the cells, as their files under bench_torch/workloads give them
CELL_NAMES = list(cells.CELLS)
#: the cells the benchmark was defined with, in order, and their regression
#: bounds: 8 % on the captured small chains, 5 % on the others
FIRST_CELLS = {"fft64k_int16_b64": 0.05, "c3_channelizer_cn": 0.05,
               "c3_channelizer_nc": 0.05, "c2_unscaled32_chain_b8": 0.08,
               "c4_overlap_save_t4": 0.08, "c4_overlap_save_t64": 0.05,
               "fft512k_flat_b8": 0.05, "fft1m_blocks_b4": 0.05,
               "fft16m_blocks_b1": 0.05}


def _jax(cfg):
    """The JAX package's config of the port's ``cfg``."""
    return JaxConfig(**dataclasses.asdict(cfg))


def _jax_large(plan, **kw):
    return jp.LargeFFTPlan(_jax(plan.cfg), plan.n1, plan.n2,
                           inverse=plan.inverse, order=plan.order,
                           interpret=True, **kw)


def _jax_output(builder, run):
    """The JAX counterpart of a cell's call on its stimulus, as int64."""
    xr, xi = run.stimulus[:2]
    if builder in ("headline", "flat", "blocks_square"):
        return _jax_large(run.plans[0])(xr, xi)
    if builder == "blocks_chain":
        a, b = run.plans
        return _jax_large(b)(*_jax_large(a)(xr, xi))
    if builder == "config2":
        # the product is the exact unity 2^23 >> 23 (tests/test_torch_wide)
        fwd, inv = run.plans
        return _jax_large(inv)(*_jax_large(fwd)(xr, xi))
    if builder == "channelizer":
        chz = run.plans[0]
        jch = JaxChannelizer(_jax(chz.cfg), cpu_mesh((8,), ("ch",)),
                             layout=chz.layout)
        return jch(jch.shard(xr), jch.shard(xi))
    conv = run.plans[0]
    s = conv.spec
    spec = jax_conv_spec(n=s.n, taps_len=s.taps_len, twiddle_width=16,
                         max_product_width=44, max_spectrum_width=25)
    return JaxConv(spec, *run.stimulus[2:], mesh=None, interpret=True)(xr, xi)


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell_vs_golden_and_jax(name):
    """Each cell at its tiny size on the CPU: its output == the port's
    golden model (and its SNR == the golden output's) == the JAX plan."""
    run = cells.build(name, "cpu", tiny=True)
    checked = cells.check(run)
    assert checked["correct"]
    if run.snr is not None:
        assert np.isfinite(checked["snr_db"])
    y = run.output()
    for a, b in zip(y, _jax_output(cells.CELLS[name].builder, run)):
        np.testing.assert_array_equal(a, np.asarray(b, np.int64).reshape(
            a.shape))
    # the timed call feeds itself: its output has its input's shape
    z = run.fn(*run.x)
    assert [tuple(v.shape) for v in z] == [tuple(v.shape) for v in run.x]
    assert bench_main.launches(run) == {}          # the CPU launches none


def _roofline(builder, n, batch=1, channels=0, payloads=0, taps_len=0,
              **_):
    """A cell's work from its sizes by ``intfftk_tpu_torch.utils.roofline``:
    (ops, bytes)."""
    if builder == "channelizer":
        c = fft_cost(n, channels)
        return c.int_ops, c.hbm_bytes
    if builder in ("headline", "flat", "blocks_square"):
        c = large_fft_cost(n, batch, itemsize=2)
        return c.int_ops, c.hbm_bytes
    if builder == "blocks_chain":
        c = large_fft_cost(n, 2 * batch, itemsize=2, crossings=1)
        return c.int_ops, c.hbm_bytes
    if builder == "config2":
        t = large_fft_cost(n, batch)
        moved = (large_fft_cost(n, batch, itemsize=4, crossings=1).hbm_bytes
                 + large_fft_cost(n, batch, itemsize=8, crossings=1).hbm_bytes)
        return 2 * t.int_ops + batch * n * 12, moved + n * 2 * 4
    assert builder == "config4"
    t = payloads * (n - taps_len + 1)
    c = large_fft_cost(n, payloads)
    moved = (large_fft_cost(t, 1, itemsize=4, crossings=1).hbm_bytes
             + large_fft_cost(t, 1, itemsize=8, crossings=1).hbm_bytes)
    return 2 * c.int_ops + payloads * n * 12, moved + n * 2 * 4


@pytest.mark.parametrize("name", CELL_NAMES)
def test_count_matches_roofline(name):
    """count.py's bytes and ops of every cell equal the port's cost model
    (utils/roofline.py) on the same sizes, at the tiny and the full size
    (the full size from the cell's file, without building it); the tiny
    build carries the same count."""
    builder = cells.CELLS[name].builder
    for tiny in (True, False):
        w = cells.work(name, tiny)
        assert (w.ops, w.bytes) == _roofline(builder,
                                             **cells.sizes(name, tiny))
        bound, by = w.bound()
        assert bound > 0 and by in ("bytes", "operations")
    run = cells.build(name, "cpu", tiny=True)
    assert run.work == cells.work(name, tiny=True)
    assert run.chain == cells.CELLS[name].chain


def test_bound_constants():
    """The bound's two rates are the card's readings named in PERF.md."""
    assert (count.BYTES_PER_S, count.OPS_PER_S) == (3.352e12, 52.311e12)
    w = count.Work(52_311_000_000, 0)
    assert w.bound() == (pytest.approx(1.0), "operations")
    assert count.Work(0, 3_352_000_000).bound() == (pytest.approx(1.0),
                                                    "bytes")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snr_helper_equals_jax(seed):
    """The port's snr_db == intfftk_tpu.config.snr_db on the same arrays,
    the exact (infinite) case included."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=256) + 1j * rng.normal(size=256)
    test = np.round(ref * 1000) / 1000
    assert snr_db(ref, test) == jax_snr_db(ref, test)
    assert snr_db(ref, ref) == jax_snr_db(ref, ref) == np.inf


def test_headline_snr_is_golden():
    """The headline's tone and white SNRs at n = 4096 on the CPU: finite,
    each equal to the golden output's."""
    run = cells.build("fft64k_int16_b64", "cpu", tiny=True)
    out = cells.headline_snr(run.plans[0], "cpu")
    assert out["correct"]
    assert out["snr_db"] == out["snr_db_golden"] > out["snr_db_white"]
    assert np.isfinite(out["snr_db_white"])


def test_verify_family_names():
    """Every family of VERIFY_r05.json keeps its name, and the new edges
    bring the set to 28 or more."""
    r05 = json.loads((REPO / "VERIFY_r05.json").read_text())["verified"]
    assert len(r05) == 23 and set(r05) <= set(verify.NAMES)
    assert len(verify.NAMES) >= 28 and len(set(verify.NAMES)) == len(
        verify.NAMES)
    new = set(verify.NAMES) - set(r05)
    assert {"large_4m_split_inverse", "large_16m_split_inverse",
            "taylor_4k_tw18", "large_1m_wide_int64", "staged_xla_512k",
            "whole_64k_scaled", "whole_c2_chain"} == new
    large = {f.name for f in verify.FAMILIES if f.large}
    assert all(("512k" in k or "1m" in k or "4m" in k or "16m" in k)
               for k in large)


def test_verify_detects_a_mismatch():
    """The families' comparison: equal arrays pass; one changed value, a
    changed shape or a missing array fails."""
    g = [np.arange(6).reshape(2, 3), np.zeros((2, 3), np.int64)]
    d = [torch.arange(6).reshape(2, 3), torch.zeros(2, 3, dtype=torch.int32)]
    assert verify._equal(g, d)
    bad = d[0].clone()
    bad[1, 2] += 1
    assert not verify._equal(g, [bad, d[1]])
    assert not verify._equal(g, [d[0].reshape(3, 2), d[1]])
    assert not verify._equal(g, d[:1])


def test_verify_one_family_on_cpu():
    """One family end to end through ``verify`` on the CPU."""
    seen = []
    out = verify.verify("cpu", large=False, names={"fused_1k_scaled_round"},
                        log=lambda n, ok: seen.append((n, ok)))
    assert out == seen == [("fused_1k_scaled_round", True)]


def _x():
    return torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 4,
                                                             dtype=torch.int32)


TIMERS = [lambda f, a, b: timing.replayed(f, a, b),
          lambda f, a, b: timing.event_ms(f, a, b, calls=2),
          lambda f, a, b: timing.paced(f, a, b, calls=2),
          lambda f, a, b: timing.captured_ms(f, a, b, calls=2),
          lambda f, a, b: timing.readings(f, a, b, calls=2, count=2),
          lambda f, a, b: timing.readings(f, a, b, calls=2, count=2,
                                          capture=False)]


@pytest.mark.parametrize("cuda", [False, True], ids=["no_cuda", "cpu_input"])
@pytest.mark.parametrize("timer", range(len(TIMERS)))
def test_timing_raises_without_the_card(monkeypatch, timer, cuda):
    """Every timing function raises RuntimeError where there is no CUDA,
    and where its input lies on the CPU: it never times the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    calls = []

    def fn(a, b):
        calls.append(1)
        return a, b

    with pytest.raises(RuntimeError, match="CUDA|card"):
        TIMERS[timer](fn, *_x())
    assert not calls


def test_readings_summary():
    """Median, p75 and count of individually timed readings, the rate at
    each (the p75 reading is the slower one), and the rate over the whole
    window, which a stalled reading moves where the median does not."""
    values = tuple(float(v) for v in range(1, 41))
    r = timing.Readings(values, sum(values) / 40)
    assert (r.median, r.p75, r.count) == (20.5, 30.25, 40)
    rates = r.rates(1000)
    assert rates["median"] == pytest.approx(1000 / 20.5 / 1e3)
    assert rates["p75"] < rates["median"] and rates["count"] == 40
    assert r.rate(1000) == pytest.approx(1000 / 20.5 / 1e3)
    assert r.summary() == {"window": 20.5, "median": 20.5, "p75": 30.25,
                           "count": 40}
    stalled = timing.Readings(values[:-1] + (400.0,),
                              (sum(values) - 40 + 400) / 40)
    assert stalled.median == r.median
    assert stalled.rate(1000) < 0.75 * r.rate(1000)


def test_cell_choices():
    """``--cell`` offers the cells in the order of their files, the first
    nine the benchmark's own with their regression bounds; the 2M and 4M
    sizes are reported lines, no choice."""
    assert list(cells.CELLS)[:len(FIRST_CELLS)] == list(FIRST_CELLS)
    for name, bound in FIRST_CELLS.items():
        assert cells.CELLS[name].regression_bound == bound
    assert list(cells.REPORTED) == ["fft2m_blocks_b2", "fft4m_blocks_b1"]
    args = bench_main.parse(["--cell", "c4_overlap_save_t4"])
    assert args.cell == "c4_overlap_save_t4"
    for bad in ("fft64k", "fft2m_blocks_b2"):
        with pytest.raises(SystemExit):
            bench_main.parse(["--cell", bad])


def test_cell_files(tmp_path):
    """Every file under bench_torch/workloads names a build function, its
    sizes at both scales, a chain and, for a cell, a bound; a new file is a
    new cell, and a file that names no known build function or a cell
    without a bound is refused."""
    files = sorted((REPO / "bench_torch" / "workloads").glob("*.json"))
    assert sorted(p.stem for p in files) == sorted(
        list(cells.CELLS) + list(cells.REPORTED))
    for cell in [*cells.CELLS.values(), *cells.REPORTED.values()]:
        assert cell.builder in cells.BUILDERS and cell.chain >= 1
        assert cell.tiny and cell.kwargs and cell.configuration
    d = json.loads(files[0].read_text())
    for i, (extra, ok) in enumerate((
            (dict(order=0), True), (dict(builder="nope"), False),
            (dict(kind="cell", regression_bound=None), False))):
        tmp = tmp_path / str(i)
        tmp.mkdir()
        (tmp / "new_cell.json").write_text(json.dumps(dict(d, **extra)))
        if ok:
            assert list(cells.load(tmp)) == ["new_cell"]
        else:
            with pytest.raises(ValueError):
                cells.load(tmp)


def test_git_rev_outside_a_repository(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_main, "ROOT", tmp_path)
    assert bench_main.git_rev() is None


def _bench(*args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "bench_torch", *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=env)


def test_smoke_subprocess():
    """``python -m bench_torch --smoke`` exits 0; every line is JSON with
    bits and counts and no rate or time; the last says correct."""
    out = _bench("--smoke")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(v) for v in out.stdout.strip().splitlines()]
    assert [v["cell"] for v in lines[:-1]] == CELL_NAMES
    assert all(v["correct"] and v["device"] == "cpu" for v in lines)
    for v in lines:
        assert not any("msamples" in k or k.endswith("_ms") or k == "value"
                       for k in v)
    last = lines[-1]
    assert last["smoke"] and all(last["verified"].values())
    assert len(last["verified"]) == sum(not f.large for f in verify.FAMILIES)


def test_no_card_raises():
    """Without ``--smoke`` the benchmark needs a card: no CUDA raises
    RuntimeError naming --smoke, and prints no line."""
    out = _bench("--cell", "fft64k_int16_b64")
    assert out.returncode != 0 and out.stdout == ""
    assert "RuntimeError" in out.stderr and "--smoke" in out.stderr


def test_no_jax_import():
    """bench_torch imports neither JAX nor the JAX package."""
    code = ("import sys, bench_torch.__main__, bench_torch.verify; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'intfftk_tpu.'))"
            " or m == 'intfftk_tpu' for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
