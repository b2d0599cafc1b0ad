"""Exact integer twiddle-factor synthesis (host-side oracle).

Reproduces, bit-for-bit, the twiddle stream the reference hardware generates
per stage:

* quarter-wave compressed ROM with quadrant folding by multiplication with -j
  (``reference/src/vhdl/twiddle/rom_twiddle_int.vhd:118-184``),
* magnitude 2^(w-1)-1 below 18 bits / 2^(w-2)-1 at >= 18 bits
  (``rom_twiddle_int.vhd:143-147``),
* for stages >= 11: 512-entry coarse table plus first-order integer Taylor
  correction computed in a DSP48 MACC with round-half-up
  (``rom_twiddle_int.vhd:215-246``, ``row_twiddle_tay.vhd:134-268``).

A stage of twiddle order ``p`` produces the stream W_k = exp(-j*pi*k / 2^p)
for k = 0 .. 2^p - 1 (the DIF forward convention; DIT/IFFT conjugates).

All arithmetic here is plain NumPy int64 — this module is the *specification*;
the TPU compute path precomputes these tables (or synthesizes them in-kernel)
and is tested against this module.
"""

from __future__ import annotations

import math

import numpy as np

from .config import TAYLOR_COARSE_BITS, TAYLOR_STAGE


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """Round to nearest, ties away from zero (VHDL INTEGER(real) semantics
    used for ROM initialization)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


def magnitude(width: int) -> int:
    """Quantized twiddle magnitude (``rom_twiddle_int.vhd:143-147``)."""
    return (1 << (width - 1)) - 1 if width < 18 else (1 << (width - 2)) - 1


def quarter_table(depth_bits: int, width: int):
    """Quarter-wave ROM of 2^depth_bits entries.

    Entry ii holds (re, im) = round(mag*cos(th)), round(mag*sin(-th)) with
    th = ii*pi/2^(depth_bits+1) — the reference's angle step with
    xN = depth_bits (``rom_twiddle_int.vhd:148-156``).
    """
    mag = magnitude(width)
    ii = np.arange(1 << depth_bits, dtype=np.float64)
    theta = ii * math.pi / float(1 << (depth_bits + 1))
    re = _round_half_away(mag * np.cos(theta))
    im = _round_half_away(mag * np.sin(-theta))
    return re, im


def _fold_neg_j(re: np.ndarray, im: np.ndarray):
    """Quadrant fold: multiply by -j, i.e. (re, im) -> (im, -re)
    (``rom_twiddle_int.vhd:174-184``; plain two's-complement negate)."""
    return im, -re


def taylor_mathpi(stage_ii: int, ser: str = "old") -> int:
    """The per-stage pi constant of the Taylor interpolator.

    MATHPI = INTEGER(MATH_PI * 2^(13-ii-del)), del = 0 for XSER="OLD"
    (DSP48E1) and 2 for XSER="NEW" (DSP48E2)
    (``row_twiddle_tay.vhd:134-148``); VHDL INTEGER(real) rounds to
    nearest, so pi*2^13 -> 25736.
    """
    pi_shift = 13 if ser == "old" else 11
    return int(math.pi * float(1 << (pi_shift - stage_ii)) + 0.5)


def taylor_mpi(count, stage_ii: int, ser: str = "old",
               use_mlt: bool = False):
    """The raw angle product mpi = MATHPI * count, by either reference
    path (``USE_MLT`` generic):

    * FALSE — a 2^(ii+1)-deep ROM of ``conv_std_logic_vector(MATHPI*jj,
      16)`` entries, i.e. the product wrapped to 16 bits
      (``row_twiddle_tay.vhd:206-221``),
    * TRUE — an 18x18 DSP unsigned multiply of the 16-bit constant by the
      8-bit counter, kept at full width in the 24-bit ``mpi`` signal
      (:225-240).

    The two are bit-identical for every legal configuration: the product
    is bounded by MATHPI*(2^(ii+1)-1) < pi*2^14 = 51471.9 < 2^16, so the
    ROM's 16-bit wrap never engages (proven by
    tests/test_golden.py::test_taylor_use_mlt_equivalence).
    """
    mathpi = taylor_mathpi(stage_ii, ser)
    count = np.asarray(count).astype(np.int64)
    if use_mlt:
        return mathpi * count                  # full 24-bit DSP product
    return (mathpi * count) & 0xFFFF           # 16-bit ROM entries


def _taylor_correct(re, im, count, stage_ii, ser: str = "old",
                    use_mlt: bool = False):
    """First-order integer Taylor correction for long stages.

    Mirrors ``row_twiddle_tay.vhd``:
      * MATHPI per ``taylor_mathpi``           (:134-148)
      * mpi    = MATHPI * count                (:206-240, see taylor_mpi)
      * mpx    = (mpi mod 2^18) >> 1           (:247)
      * re'    = rnd((re << XS) + im*mpx) >> XS (MULT_SUB, ALUMODE 0000)
      * im'    = rnd((im << XS) - re*mpx) >> XS (MULT_ADD, ALUMODE 0011)
    with XS = XSHIFT = 23 (XSER="OLD") or 21 ("NEW") (:123-132) and
    rnd = round-half-up applied at bit (XS-1) (:177-196).

    ``count`` is the low stage-counter slice; the correction rotates the
    (already quadrant-folded) coarse twiddle by delta = count*pi/2^stage.
    """
    xshift = 23 if ser == "old" else 21
    mpi = taylor_mpi(count, stage_ii, ser, use_mlt)
    mpx = (mpi & 0x3FFFF) >> 1                 # B-port slice mpi(17..1)

    def rnd_shift(v):
        # slice (47 downto xshift-1) then round-half-up on the LSB
        t = v >> (xshift - 1)
        return (t >> 1) + (t & 1)

    re_new = rnd_shift((re.astype(np.int64) << xshift) + im.astype(np.int64) * mpx)
    im_new = rnd_shift((im.astype(np.int64) << xshift) - re.astype(np.int64) * mpx)
    return re_new, im_new


def stage_twiddles_int(p: int, width: int, twiddle_gen: str = "auto"):
    """Integer twiddle stream of a stage with twiddle order ``p``.

    Returns int64 arrays (re, im) of length 2^p holding the quantized
    W_k = exp(-j*pi*k/2^p), k = 0..2^p-1, exactly as the hardware streams
    them (quarter-wave ROM + fold, Taylor for p >= 11 unless
    ``twiddle_gen == "rom"``).

    ``twiddle_gen``: "auto"/"taylor_old" — Taylor stages use the
    XSER="OLD" (DSP48E1) constant set; "taylor_new" — the XSER="NEW"
    (DSP48E2) set (XSHIFT 21 and pi*2^(11-ii), ``row_twiddle_tay.vhd:
    123-148``); "rom" — full quarter-wave tables for every stage.  The
    USE_MLT generic needs no knob: both of its paths are bit-identical
    (see ``taylor_mpi``).

    p = 0 -> [1] (W=1; the hardware multiplies by nothing, magnitude moot)
    p = 1 -> [1, -j] exact (stage handled by swap/negate, no ROM)
    """
    if p == 0:
        return (np.array([1], dtype=np.int64), np.array([0], dtype=np.int64))
    if p == 1:
        # exact {1, -j}; the butterfly implements this by re/im swap + negate
        return (np.array([1, 0], dtype=np.int64), np.array([0, -1], dtype=np.int64))

    k = np.arange(1 << p, dtype=np.int64)
    # cnt register is p bits: MSB selects the quadrant fold, low p-1 bits
    # address the ROM (rom_twiddle_int.vhd:187-189)
    addr = k & ((1 << (p - 1)) - 1)
    div = (k >> (p - 1)) & 1

    if p < TAYLOR_STAGE or twiddle_gen == "rom":
        qre, qim = quarter_table(p - 1, width)
        re, im = qre[addr], qim[addr]
        fre, fim = _fold_neg_j(re, im)
        re = np.where(div == 1, fre, re)
        im = np.where(div == 1, fim, im)
        return re, im

    # Taylor path: coarse 512-entry table indexed by the top 9 address bits
    # (rom_twiddle_int.vhd:215-227), correction from the low bits.
    cb = TAYLOR_COARSE_BITS
    coarse_re, coarse_im = quarter_table(cb, width)
    addrx = addr >> (p - 1 - cb)
    count = addr & ((1 << (p - 1 - cb)) - 1)
    re, im = coarse_re[addrx], coarse_im[addrx]
    fre, fim = _fold_neg_j(re, im)
    re = np.where(div == 1, fre, re)
    im = np.where(div == 1, fim, im)
    # ii generic = STAGE-11 (rom_twiddle_int.vhd:234)
    ser = "new" if twiddle_gen == "taylor_new" else "old"
    re, im = _taylor_correct(re, im, count, stage_ii=p - TAYLOR_STAGE,
                             ser=ser)
    return re, im


def circle_twiddles_int(n: int, width: int, twiddle_gen: str = "auto"):
    """Full-circle quantized twiddles W_N^m = exp(-2j*pi*m/N), m = 0..N-1.

    The inter-factor twiddle table of the four-step decomposition (the
    reference's guidance for N > 512K: compose a 2D scheme from the cores,
    ``int_fftNk.vhd:13``, ``row_twiddle_tay.vhd:22``).  Built from the same
    half-circle stage table as the cores — exp(-2j*pi*m/2^L) equals the
    stage-(L-1) entry W_k with k = m for m < N/2 and -W_{m-N/2} above
    (half-turn fold), so quantization is identical to the in-core twiddles.
    """
    assert n >= 4 and (n & (n - 1)) == 0
    p = n.bit_length() - 2          # stage order covering the half circle
    re_h, im_h = stage_twiddles_int(p, width, twiddle_gen)
    re = np.concatenate([re_h, -re_h])
    im = np.concatenate([im_h, -im_h])
    return re, im


def stage_twiddles_float(p: int) -> np.ndarray:
    """Unquantized stage twiddles exp(-j*pi*k/2^p) (float oracle)."""
    k = np.arange(1 << p, dtype=np.float64)
    return np.exp(-1j * math.pi * k / float(1 << p))
