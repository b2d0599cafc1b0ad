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

from typing import NamedTuple

import torch

from ..config import FFTConfig, TAYLOR_COARSE_BITS, TAYLOR_STAGE
from ..golden.twiddle import quarter_table, taylor_mathpi

from ..device import resolve, use_kernel
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
    log_n = n.bit_length() - 1
    p = log_n - 1                        # half-circle stage order
    if p < TAYLOR_STAGE or 1 << log_n != n:
        raise ValueError(f"twiddle synthesis needs a power of two n >= "
                         f"{2 << TAYLOR_STAGE}, got {n}")
    ser = "new" if cfg.twiddle_gen == "taylor_new" else "old"
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


def device_circle_table(cfg: FFTConfig, n: int, n1: int, n2: int,
                        inverse: bool, device=None, coarse=None):
    """The [n1, n2] epilogue table generated on ``device`` from the 4 KiB
    coarse table: one launch of the generator kernel on a CUDA device
    (counted in ``device_circle_table.launches``), ``synth_circle_block``
    on the CPU.  No O(N) array is built on the host.  ``device``: the
    current CUDA device unless named (``device.resolve``).  ``coarse``: the
    tensors of ``coarse_table`` already on the device (else uploaded)."""
    if coarse is None:
        coarse = coarse_table(cfg, resolve(device))
    dev = coarse[0].device
    if not use_kernel(dev):
        return synth_circle_block(coarse, n1, n2, 0, n, cfg, inverse)
    check_block(n1, n2, 0, n)
    prm = synth_params(cfg, n)
    er = torch.empty((n1, n2), dtype=torch.int32, device=dev)
    ei = torch.empty((n1, n2), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.intfft_circle_table(
        coarse[0].data_ptr(), coarse[1].data_ptr(), er.data_ptr(),
        ei.data_ptr(), n1, n2, int(inverse), *prm, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "circle_table launch")
    device_circle_table.launches += 1
    return er, ei


#: Generator launches made by ``device_circle_table`` (a plain count).
device_circle_table.launches = 0
