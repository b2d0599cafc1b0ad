"""The benchmark's cells: each a path of the port at a size its users run,
built on a device from a seed, with what its timed call is and what its
output must equal.

Counterparts of ``bench.py``'s ``bench_64k`` / ``bench_64k_flat`` /
``headline_snr`` (the headline), ``bench_config2``, ``bench_config3``,
``bench_config4``, ``bench_large`` and ``bench_large_blocks``.  Every
build function takes the device and the seed, and its sizes as keywords,
so the same function runs at a tiny size on the CPU (the plain versions)
and at full size on the card.  What a cell's numbers are is ``__main__``'s:
this module builds and checks, it times nothing.

The cells are data: one JSON file per cell (or reported line) under
``workloads/``, read at import.  A file names its build function
(``BUILDERS``), its sizes at full scale (``kwargs``) and on the CPU
(``tiny``), the chained calls of one timed reading (``chain``), its
``regression_bound``, whether it is read in every ``epi_synth`` mode
(``per_mode``), its place (``order``) and ``kind``: ``"cell"``, or
``"line"`` for a size that is reported and bounds nothing.  A new cell of
an existing path is one new file.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from intfftk_tpu_torch.config import FFTConfig, snr_db
from intfftk_tpu_torch.golden import (fft_int, four_step_int, make_conv_spec,
                                      overlap_save_int)
from intfftk_tpu_torch.ops.fused_fft import LargeFFTPlan
from intfftk_tpu_torch.ops.pair import FFTPairPlan
from intfftk_tpu_torch.parallel import Channelizer, OverlapSaveConv

from . import count

#: the epilogue twiddle modes of the large-n cells' per-mode readings
EPI_MODES = ("host", "device", "inkernel")
#: the cells' data files
WORKLOADS = Path(__file__).resolve().parent / "workloads"


@dataclasses.dataclass
class Run:
    """One cell built on a device.

    ``call`` is one call of the path, (a, b) -> its output tensors; ``x``
    its inputs on the device, ``stimulus`` the numpy arrays they were made
    from (and the convolution's taps).  ``feeds``: the output of a call has
    the shape and dtype of its input and feeds the next call; else each
    chained call rereads ``x`` (a widening path).  ``samples``: the samples
    one call counts in Msamples/s; ``batch``: the leading dimension of its
    output as numpy (None: flat); ``capture``: read from a CUDA graph (else
    eagerly).  ``reference()`` is what one call's output on ``x`` must
    equal; ``snr(y)``, where set, the SNR of a result, which must equal
    that of the reference.  ``work`` (operations and bytes, ``count``) and
    ``chain`` (calls per reading) are the cell's data, set by ``build``."""

    call: Callable
    x: tuple
    stimulus: tuple
    samples: int
    reference: Callable
    batch: int | None = None
    feeds: bool = True
    capture: bool = True
    snr: Callable | None = None
    plans: tuple = ()
    work: count.Work | None = None
    chain: int = 1

    @property
    def fn(self) -> Callable:
        """The chained call, (a, b) -> (a', b'): ``call`` where it feeds
        itself, else ``call`` returning its own inputs."""
        if self.feeds:
            return self.call
        call = self.call
        return lambda a, b: (call(a, b), (a, b))[1]

    def output(self, y=None) -> list:
        """``y`` (one eager call on ``x`` where None) as int64 numpy."""
        return numpy64(self.call(*self.x) if y is None else y, self.batch)


def numpy64(y, batch: int | None = None) -> list:
    """Tensors as int64 numpy arrays, flattened to [batch, -1]."""
    return [t.detach().cpu().numpy().astype(np.int64).reshape(
        (batch, -1) if batch else (-1,)) for t in y]


def data(shape, seed: int, width: int = 15):
    """Random ``width``-bit re and im (``bench.py``'s ``_devdata``)."""
    rng = np.random.default_rng(seed)
    lim = 1 << (width - 1)
    return rng.integers(-lim, lim, shape), rng.integers(-lim, lim, shape)


def config16(n: int) -> FFTConfig:
    """Scaled/round, 16-bit data and twiddles: the reference's core."""
    return FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                     twiddle_width=16)


def square(cfg: FFTConfig, **kw) -> LargeFFTPlan:
    """The plan of ``cfg`` on square factors (256 x 256 at 64k, 4096 x
    4096 at 16M, as the default split gives them there), so that its output
    blocks are its input blocks."""
    r = 1 << (cfg.stages // 2)
    if r * r != cfg.n:
        raise ValueError(f"n = {cfg.n} does not split square")
    return LargeFFTPlan(cfg, r, r, **kw)


def to_blocks(plan, xr, xi, dev):
    """Flat [B, n] numpy as ``plan``'s input blocks on ``dev``."""
    shape = (xr.shape[0],) + plan.block_in_shape
    return tuple(torch.as_tensor(v).to(plan.in_dtype).reshape(shape).to(dev)
                 for v in (xr, xi))


def headline(dev, seed: int = 0, n: int = 1 << 16, batch: int = 64) -> Run:
    """``fft64k_int16_b64``: ``batch`` forward n-point scaled/round 16-bit
    transforms on int16 [B, 256, 256] blocks (``bench_64k``): the output
    blocks feed back as input blocks."""
    cfg = config16(n)
    plan = square(cfg, device=dev)
    xr, xi = data((batch, n), seed)
    return Run(plan.apply_blocks, to_blocks(plan, xr, xi, dev), (xr, xi),
               batch * n,
               lambda: four_step_int(xr, xi, cfg, plan.n1, plan.n2),
               batch=batch, plans=(plan,))


def headline_snr(plan, dev, seed: int = 11) -> dict:
    """(tone, white) SNR of the headline plan against the float FFT / n
    (``bench.py``'s ``headline_snr``): a near-full-scale tone with noise,
    the reference's own test signal (``math/fft_single.m:93-98``), and
    white noise; each beside the golden model's on the same stimulus.
    ``correct``: both outputs are the golden bits."""
    n = plan.cfg.n
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    tone = (0.9 * ((1 << 15) - 1) * np.exp(2j * np.pi * 1234 * t / n)
            + rng.normal(0, 64, n) + 1j * rng.normal(0, 64, n))
    stimuli = {"snr_db": (np.round(tone.real).astype(np.int64),
                          np.round(tone.imag).astype(np.int64)),
               "snr_db_white": (rng.integers(-(1 << 15), 1 << 15, n),
                                rng.integers(-(1 << 15), 1 << 15, n))}
    out, correct = {}, True
    for key, (xr, xi) in stimuli.items():
        y = numpy64(plan(*(torch.as_tensor(v[None], device=dev)
                           for v in (xr, xi))), 1)
        g = four_step_int(xr[None], xi[None], plan.cfg, plan.n1, plan.n2)
        ref = np.fft.fft(xr + 1j * xi) / n
        out[key] = snr_db(ref, y[0] + 1j * y[1])
        out[key + "_golden"] = snr_db(ref, g[0] + 1j * g[1])
        correct &= (all(np.array_equal(a, b) for a, b in zip(y, g))
                    and out[key] == out[key + "_golden"])
    out["correct"] = bool(correct)
    return out


def channelizer(dev, layout: str, seed: int | None = None,
                channels: int = 4096, n: int = 4096) -> Run:
    """``c3_channelizer_cn`` / ``_nc``: ``channels`` n-point scaled/round
    transforms through ``Channelizer`` (``bench_config3``): int32
    [channels, n] ("cn") or [n, channels] ("nc", K4's engine), read
    captured as the other cells.  Seeds as ``bench.py``'s: 0 for "cn", 1
    for "nc"."""
    cfg = FFTConfig(n=n, mode="scaled", rounding="round")
    chz = Channelizer(cfg, layout=layout, device=dev)
    seed = (0 if layout == "cn" else 1) if seed is None else seed
    xr, xi = data((channels, n) if layout == "cn" else (n, channels), seed)
    turn = (lambda v: v) if layout == "cn" else (lambda v: v.T)

    def reference():
        return [turn(g) for g in fft_int(turn(xr), turn(xi), cfg)]

    return Run(chz, (chz.shard(xr), chz.shard(xi)), (xr, xi), channels * n,
               reference, batch=xr.shape[0], plans=(chz,))


def config2(dev, seed: int = 0, n: int = 1 << 16, batch: int = 8) -> Run:
    """``c2_unscaled32_chain_b8`` (``bench_config2``): the raw unscaled
    int32 forward to 48 bits, the 25-bit spectrum product (P1) by the
    unity spectrum 2^23 >> 23, the raw scaled/round inverse, through
    ``FFTPairPlan``; each call rereads one input (its int64 output cannot
    feed it).  Msamples/s counts both transforms."""
    cfg = FFTConfig(n=n, mode="unscaled", data_width=32, twiddle_width=20)
    unity = (np.full(n, 1 << 23), np.zeros(n, np.int64))
    pair = FFTPairPlan(cfg, unity, product_shift=23, spectrum_width=25,
                       device=dev)
    fwd, inv = pair.fwd, pair.inv
    rng = np.random.default_rng(seed)
    xr = rng.integers(-(1 << 27), 1 << 27, (batch, n))
    xi = rng.integers(-(1 << 27), 1 << 27, (batch, n))

    def reference():
        g = four_step_int(xr, xi, cfg, fwd.n1, fwd.n2)
        return four_step_int(*g, inv.cfg, inv.n1, inv.n2, inverse=True)

    return Run(pair, to_blocks(fwd, xr, xi, dev), (xr, xi), 2 * batch * n,
               reference, batch=batch, feeds=False,
               snr=lambda y: snr_db(xr + 1j * xi, y[0] + 1j * y[1]),
               plans=(fwd, inv))


def config4(dev, payloads: int, seed: int = 1, n: int = 1 << 16,
            taps_len: int = (1 << 13) + 1) -> Run:
    """``c4_overlap_save_t4`` / ``_t64`` (``bench_config4``): overlap-save
    of ``payloads`` payloads against ``taps_len`` real taps in n-point
    blocks, a 44-bit product and a 25-bit taps spectrum, taps and data in
    +-2^13 from one generator; each call rereads one input.  Msamples/s
    counts payload samples."""
    spec = make_conv_spec(n=n, taps_len=taps_len, twiddle_width=16,
                          max_product_width=44, max_spectrum_width=25)
    rng = np.random.default_rng(seed)
    m = spec.taps_len
    h_re, h_im = rng.integers(-(1 << 13), 1 << 13, m), np.zeros(m, np.int64)
    conv = OverlapSaveConv(spec, h_re, h_im, device=dev)
    t = spec.payload * payloads
    xr = rng.integers(-(1 << 13), 1 << 13, t)
    xi = rng.integers(-(1 << 13), 1 << 13, t)
    x = tuple(torch.as_tensor(v, dtype=torch.int32, device=dev)
              for v in (xr, xi))
    size = 1 << (t + m).bit_length()
    ref = np.fft.ifft(np.fft.fft(xr + 1j * xi, size)
                      * np.fft.fft(h_re, size))[:t] / (1 << spec.scale_log2)
    return Run(conv, x, (xr, xi, h_re, h_im), t,
               lambda: overlap_save_int(xr, xi, h_re, h_im, spec),
               feeds=False, snr=lambda y: snr_db(ref, y[0] + 1j * y[1]),
               plans=(conv,))


def flat(dev, seed: int = 0, n: int = 1 << 19, batch: int = 8) -> Run:
    """``fft512k_flat_b8`` (``bench_large``): ``batch`` forward n-point
    scaled/round 16-bit transforms on the flat [B, n] contract."""
    cfg = config16(n)
    plan = LargeFFTPlan(cfg, device=dev)
    xr, xi = data((batch, n), seed)
    x = tuple(torch.as_tensor(v, dtype=torch.int16, device=dev)
              for v in (xr, xi))
    return Run(plan, x, (xr, xi), batch * n,
               lambda: four_step_int(xr, xi, cfg, plan.n1, plan.n2),
               batch=batch, plans=(plan,))


def blocks_chain(dev, seed: int = 0, n: int = 1 << 20, batch: int = 4,
                 epi_synth: str = "auto") -> Run:
    """``fft1m_blocks_b4`` (``bench_large_blocks``): plan a, then plan b
    with the factors swapped, whose input block is a's output block;
    n-point scaled/round 16-bit transforms on int16 blocks, two per item
    and call."""
    cfg = config16(n)
    a = LargeFFTPlan(cfg, epi_synth=epi_synth, device=dev)
    b = LargeFFTPlan(cfg, a.n2, a.n1, epi_synth=epi_synth, device=dev)
    xr, xi = data((batch, n), seed)

    def chain(u, v):
        return b.apply_blocks(*a.apply_blocks(u, v))

    def reference():
        g = four_step_int(xr, xi, cfg, a.n1, a.n2)
        return four_step_int(*g, cfg, b.n1, b.n2)

    return Run(chain, to_blocks(a, xr, xi, dev), (xr, xi), 2 * batch * n,
               reference, batch=batch, plans=(a, b))


def blocks_square(dev, seed: int = 0, n: int = 1 << 24, batch: int = 1,
                  epi_synth: str = "auto") -> Run:
    """``fft16m_blocks_b1``: ``batch`` n-point scaled/round 16-bit
    transforms as square int16 blocks (4096 x 4096 at 16M, the author's
    2-D scheme beyond 512K, ``row_twiddle_tay.vhd:22``), fed back."""
    cfg = config16(n)
    plan = square(cfg, epi_synth=epi_synth, device=dev)
    xr, xi = data((batch, n), seed)
    return Run(plan.apply_blocks, to_blocks(plan, xr, xi, dev), (xr, xi),
               batch * n,
               lambda: four_step_int(xr, xi, cfg, plan.n1, plan.n2),
               batch=batch, plans=(plan,))


@dataclasses.dataclass(frozen=True)
class Builder:
    """A path the cells run: ``build(dev, seed=..., **sizes)`` makes its
    ``Run``; ``work(**sizes)`` counts one call's operations and bytes from
    the sizes alone (``count``), without building anything."""

    build: Callable
    work: Callable


def _config4_work(payloads, n, taps_len, **_):
    return count.config4(n, payloads, payloads * (n - taps_len + 1))


#: the build functions a cell's file may name
BUILDERS = {
    "headline": Builder(headline, lambda n, batch, **_:
                        count.four_step(n, batch, 2)),
    "channelizer": Builder(channelizer, lambda channels, n, **_:
                           count.single_pass(n, channels)),
    "config2": Builder(config2, lambda n, batch, **_:
                       count.config2(n, batch)),
    "config4": Builder(config4, _config4_work),
    "flat": Builder(flat, lambda n, batch, **_: count.four_step(n, batch, 2)),
    "blocks_chain": Builder(blocks_chain, lambda n, batch, **_:
                            count.four_step(n, batch, 2)
                            + count.four_step(n, batch, 0)),
    "blocks_square": Builder(blocks_square, lambda n, batch, **_:
                             count.four_step(n, batch, 2)),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    """A cell (or reported line) as its file gives it: its build function,
    its sizes at full scale and on the CPU, the chained calls of one
    reading, and the regression bound of its ``msamples_per_sec`` (the
    share by which it may fall before a change counts as slower; None on a
    reported line)."""

    name: str
    builder: str
    kwargs: dict
    tiny: dict
    chain: int
    kind: str = "cell"
    regression_bound: float | None = None
    #: per-mode readings of the epilogue twiddle source and the generator
    per_mode: bool = False
    configuration: str = ""


def load(directory: Path = WORKLOADS) -> dict:
    """Every file of ``directory`` as a ``Cell``, by name, in ``order``."""
    found = []
    for path in directory.glob("*.json"):
        d = json.loads(path.read_text())
        order = d.pop("order")
        cell = Cell(name=path.stem, **d)
        if cell.builder not in BUILDERS or cell.kind not in ("cell", "line"):
            raise ValueError(f"{path}: unknown builder {cell.builder!r} or "
                             f"kind {cell.kind!r}")
        if (cell.kind == "cell") != (cell.regression_bound is not None):
            raise ValueError(f"{path}: a cell has a regression bound, a "
                             f"reported line none")
        found.append((order, cell.name, cell))
    return {name: cell for _, name, cell in sorted(found)}


_ALL = load()
#: the cells, in order: name -> Cell
CELLS = {k: c for k, c in _ALL.items() if c.kind == "cell"}
#: reported lines, not cells: the large sizes between 1M and 16M
REPORTED = {k: c for k, c in _ALL.items() if c.kind == "line"}


def sizes(name: str, tiny: bool = False) -> dict:
    """The keywords of cell (or line) ``name``'s build function."""
    cell = _ALL[name]
    return dict(cell.kwargs, **(cell.tiny if tiny else {}))


def work(name: str, tiny: bool = False) -> count.Work:
    """One call's operations and bytes of ``name``, from its sizes alone."""
    return BUILDERS[_ALL[name].builder].work(**sizes(name, tiny))


def build(name: str, dev, seed: int | None = None, tiny: bool = False,
          **kwargs) -> Run:
    """Cell (or line) ``name`` built on ``dev``: at full size, or at its
    ``tiny`` sizes; ``seed`` None takes the build function's default
    (``bench.py``'s for that path); ``kwargs`` override the file's."""
    cell = _ALL[name]
    kw = dict(sizes(name, tiny), **kwargs)
    if seed is not None:
        kw["seed"] = seed
    builder = BUILDERS[cell.builder]
    run = builder.build(dev, **kw)
    run.work, run.chain = builder.work(**kw), cell.chain
    return run


def check(run: Run, *outputs) -> dict:
    """Outputs of the cell's call on its input (one eager call where none
    is given) against its reference: ``correct`` when every array of every
    output is equal and, where the cell has an SNR, the SNR of each output
    equals the reference's."""
    g = [np.asarray(v, np.int64) for v in run.reference()]
    ok, out = True, {}
    for y in [run.output(y) for y in outputs] or [run.output()]:
        ok &= len(y) == len(g) and all(
            np.array_equal(a, b) for a, b in zip(y, g))
        if run.snr is not None:
            out["snr_db"] = run.snr(y)
            out["snr_db_golden"] = run.snr(g)
            ok &= out["snr_db"] == out["snr_db_golden"]
    out["correct"] = bool(ok)
    return out
