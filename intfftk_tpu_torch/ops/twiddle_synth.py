"""Inter-factor twiddles synthesized from the 512-entry coarse quarter table.

Counterpart of ``intfftk_tpu/ops/twiddle_synth.py`` (not imported: it
imports JAX): ``can_synth`` (:52-63), ``synth_circle_block`` (:126-178)
and ``device_circle_table`` (:103-123).  The reference never holds an O(N)
twiddle table: a 512-deep quarter-wave ROM plus an exact first-order
integer Taylor MACC generates every stream (``rom_twiddle_int.vhd:40-58``,
``row_twiddle_tay.vhd:28-42``).  The split pipeline's inter-factor twiddle
W_n^(+-k1*j2) comes from that generator in two forms:

* ``device_circle_table``: the [n1, n2] epilogue table generated once, at
  plan build, by the generator kernel ``intfft_circle_table`` of
  ``csrc/fused_pass.cu`` (a CUDA device), or by ``synth_circle_block``
  (the CPU);
* in the pass itself: ``fused_pass(..., synth=EpiSynth(...))`` runs the
  same per-index function in the kernel's epilogue, so no O(N) array
  exists anywhere.

The TPU packs the coarse table into [4, 128] for its 128-lane gathers
(``packed_coarse``, ``_lookup_coarse``); on the GPU a lookup is one
indexed load, so here it is two int32 [512] vectors (``coarse_table``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..config import FFTConfig, TAYLOR_COARSE_BITS, TAYLOR_STAGE
from ..golden.twiddle import quarter_table, taylor_mathpi

from ..device import resolve, use_kernel
from ..runtime import trace
from . import _build


class EpiSynth(NamedTuple):
    """What an in-kernel epilogue needs: the coarse table (``coarse_table``)
    on the pass's device and the full transform size n."""
    re: torch.Tensor
    im: torch.Tensor
    n: int


class SynthParams(NamedTuple):
    """The generator's constants for a full size n = 2^log_n: the Taylor pi
    constant of stage order log_n - 1, the MACC's XSHIFT, and the number of
    low address bits that feed the Taylor count."""
    log_n: int
    mathpi: int
    xshift: int
    sh_cnt: int


def can_synth(cfg: FFTConfig, order: str) -> bool:
    """Synthesis covers natural order, Taylor twiddles of at most 16 bits
    and a half-circle stage order at or above TAYLOR_STAGE (n >= 4096):
    the JAX rule exactly."""
    return (order == "natural"
            and cfg.twiddle_gen != "rom"
            and cfg.twiddle_width <= 16
            and cfg.n.bit_length() - 2 >= TAYLOR_STAGE)


def coarse_table(cfg: FFTConfig, device=None):
    """The 512-entry coarse quarter table as two int32 [512] tensors, on
    ``device`` or, left out, on the host for the caller to place."""
    qre, qim = quarter_table(TAYLOR_COARSE_BITS, cfg.twiddle_width)
    return (torch.as_tensor(qre, dtype=torch.int32, device=device),
            torch.as_tensor(qim, dtype=torch.int32, device=device))


def synth_params(cfg: FFTConfig, n: int) -> SynthParams:
    """The generator's constants for the full size ``n`` under ``cfg``'s
    Taylor series (computed once per series and size)."""
    return _synth_params(cfg.twiddle_gen == "taylor_new", n)


@functools.lru_cache(maxsize=None)
def _synth_params(new: bool, n: int) -> SynthParams:
    log_n = n.bit_length() - 1
    p = log_n - 1                        # half-circle stage order
    if p < TAYLOR_STAGE or 1 << log_n != n:
        raise ValueError(f"twiddle synthesis needs a power of two n >= "
                         f"{2 << TAYLOR_STAGE}, got {n}")
    ser = "new" if new else "old"
    return SynthParams(log_n, taylor_mathpi(p - TAYLOR_STAGE, ser),
                       23 if ser == "old" else 21,
                       p - 1 - TAYLOR_COARSE_BITS)


def check_block(rows: int, cols: int, j0: int, n: int):
    """Every index m = k1*(j0 + j2) of a block must stay below n."""
    if rows < 1 or cols < 1 or j0 < 0 or (rows - 1) * (j0 + cols - 1) >= n:
        raise ValueError(f"block [{rows}, {cols}] at column {j0} reaches "
                         f"past n = {n}")


def synth_circle_block(coarse, rows: int, cols: int, j0: int, n: int,
                       cfg: FFTConfig, inverse: bool):
    """The plain version of the generator: er/ei[k1, j2] = W_n^(+-k1*(j0+j2))
    as int32 [rows, cols], bit-identical to ``circle_twiddles_int(n)[m]``.
    ``coarse``: the two tensors of ``coarse_table``; the block is built on
    their device."""
    check_block(rows, cols, j0, n)
    prm = synth_params(cfg, n)
    L = prm.log_n
    dev = coarse[0].device
    k1 = torch.arange(rows, dtype=torch.int32, device=dev)[:, None]
    j2 = j0 + torch.arange(cols, dtype=torch.int32, device=dev)[None, :]
    m = k1 * j2                          # < n: exact in int32
    if inverse:
        m = (n - m) & (n - 1)            # (-m) mod n, m = 0 fixed point
    neg = m >> (L - 1)                   # half-circle fold sign
    mm = m & ((1 << (L - 1)) - 1)
    div = mm >> (L - 2)                  # quadrant fold (x -j)
    addr = mm & ((1 << (L - 2)) - 1)
    addrx = (addr >> prm.sh_cnt).long()
    count = addr & ((1 << prm.sh_cnt) - 1)
    re, im = coarse[0][addrx], coarse[1][addrx]
    # quadrant fold: (re, im) -> (im, -re), a plain negate
    fre = torch.where(div == 1, im, re)
    fim = torch.where(div == 1, -re, im)
    # Taylor rotation by count * pi / 2^p (row_twiddle_tay MACC):
    # rnd((a << XS) +- b*mpx) >> XS is 2a + floor(+-b*mpx / 2^(XS-1)),
    # rounded half up on its LSB; |b*mpx| < 2^31 at width <= 17
    mpx = (prm.mathpi * count) >> 1
    sh = prm.xshift - 1

    def macc(a, b, sub: bool):
        q = b * mpx
        t = (a << 1) + ((-q if sub else q) >> sh)
        return (t >> 1) + (t & 1)

    tre = macc(fre, fim, sub=False)
    tim = macc(fim, fre, sub=True)
    return torch.where(neg == 1, -tre, tre), torch.where(neg == 1, -tim, tim)


#: Threads per CTA of the generator at most, the columns each thread
#: writes and the most CTAs along the rows of one grid (``kGenThreads``,
#: ``kGenCols`` of ``csrc/fused_pass.cu``, ``kMaxGridY`` of
#: ``fused_pass.cuh``).
GEN_THREADS, GEN_COLS, MAX_GRID_Y = 256, 4, 65535


class CircleLaunch(NamedTuple):
    """The generator's launch: threads per CTA and the grid (columns,
    rows)."""
    threads: int
    grid_x: int
    grid_y: int


def circle_launch(n1: int, n2: int) -> CircleLaunch:
    """The launch ``intfft_circle_table`` makes for an [n1, n2] table
    (``circle_launch`` of ``csrc/fused_pass.cu``, the same rule): threads
    per CTA the least power of two from 32 to ``GEN_THREADS`` that covers a
    row's quads of ``GEN_COLS`` columns; CTAs along the columns, enough for
    one row; along the rows one per row, at most ``MAX_GRID_Y`` (a CTA
    then walks the rows ``grid_y`` apart)."""
    quads = -(-n2 // GEN_COLS)
    threads = 32
    while threads < quads and threads < GEN_THREADS:
        threads *= 2
    return CircleLaunch(threads, -(-quads // threads), min(n1, MAX_GRID_Y))


@functools.lru_cache(maxsize=None)
def _circle_args(cfg: FFTConfig, n: int, n1: int, n2: int,
                 inverse: bool) -> tuple:
    """The integer arguments of ``intfft_circle_table`` after the table's
    size, checked once per (config, n, n1, n2, direction)."""
    check_block(n1, n2, 0, n)
    return (n1, n2, int(inverse), *synth_params(cfg, n))


#: Bytes of one entry of an [n1, n2] epilogue table: an int32 re and im.
TABLE_ENTRY_BYTES = 8


@trace.spanned("twiddle.table")
def device_circle_table(cfg: FFTConfig, n: int, n1: int, n2: int,
                        inverse: bool, device=None, coarse=None, out=None):
    """The [n1, n2] epilogue table generated on ``device`` from the 4 KiB
    coarse table: one launch of the generator kernel on a CUDA device
    (counted in ``device_circle_table.launches``; its launch is
    ``device_circle_table.launch``, a ``CircleLaunch``),
    ``synth_circle_block`` on the CPU.  No O(N) array is built on the
    host.  ``device``: the current CUDA device unless named
    (``device.resolve``).  ``coarse``: the tensors of ``coarse_table``
    already on the device (else uploaded).  ``out``: two contiguous int32
    [n1, n2] tensors on the coarse table's device to write (else
    allocated); with ``coarse`` and ``out`` given a call allocates nothing
    and does not synchronise, so a CUDA graph captures it.  Returns the
    pair written.  While a recording is open each call is a span
    ``twiddle.table`` noting its source, shape and bytes, e.g. "device
    4096x4096 134217728"."""
    trace.note(f"device {n1}x{n2} {TABLE_ENTRY_BYTES * n1 * n2}")
    if coarse is None:
        coarse = coarse_table(cfg, resolve(device))
    dev = coarse[0].device
    if out is not None and any(
            t.dtype != torch.int32 or tuple(t.shape) != (n1, n2)
            or t.device != dev or not t.is_contiguous() for t in out):
        raise ValueError(f"out takes two contiguous int32 [{n1}, {n2}] "
                         f"tensors on {dev}")
    if not use_kernel(dev):
        er, ei = synth_circle_block(coarse, n1, n2, 0, n, cfg, inverse)
        if out is None:
            return er, ei
        out[0].copy_(er)
        out[1].copy_(ei)
        return out
    args = _circle_args(cfg, n, n1, n2, bool(inverse))
    er, ei = out if out is not None else (
        torch.empty((n1, n2), dtype=torch.int32, device=dev)
        for _ in range(2))
    lib = _build.library()
    launch = (ctypes.c_int * 3)()
    err = lib.intfft_circle_table(
        coarse[0].data_ptr(), coarse[1].data_ptr(), er.data_ptr(),
        ei.data_ptr(), *args, dev.index,
        torch.cuda.current_stream(dev).cuda_stream, launch)
    _build.check(lib, err, "circle_table launch")
    device_circle_table.launches += 1
    device_circle_table.launch = CircleLaunch(*launch)
    return er, ei


#: Generator launches made by ``device_circle_table`` (a plain count), and
#: the last launch's geometry.
device_circle_table.launches = 0
device_circle_table.launch = None
