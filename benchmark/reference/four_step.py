"""Four-step (Bailey) decomposition — golden host model.

The reference scales beyond N = 512K by composing a 2D scheme from its
cores (``reference/src/vhdl/fft/int_fftNk.vhd:13``,
``src/vhdl/twiddle/row_twiddle_tay.vhd:22`` both direct the user to a
2D-FFT for larger N).  This module is the executable spec of that
composition — the oracle for the distributed (mesh-sharded) device path in
``parallel.four_step``.

Index algebra (N = N1*N2, input n = n1*N2 + n2, output k = k2*N1 + k1):

    X[k2*N1 + k1] = sum_n2 W_N2^(n2 k2) * W_N^(n2 k1)
                        * [ sum_n1 A[n1, n2] * W_N1^(n1 k1) ]

1. column FFTs  : length-N1 transform over n1 for every n2
2. twiddle      : multiply by W_N^(n2*k1)  (quantized full-circle table)
3. row FFTs     : length-N2 transform over n2 for every k1
4. corner turn  : X natural = D[k1, k2] transposed and flattened

Numerics: both passes are the exact integer cores (any mode/width); the
inter-factor twiddle multiply uses the same quantization, renormalizing
floor-shift, and wrap semantics as the in-core stage multiplies
(``int_cmult_dsp48.vhd:189-190``), so the composed transform carries the
same per-sample growth/scale contract as a monolithic core of size N:
scaled -> 1/N total, unscaled -> log2(N) bits of growth.  The composed
result is *not* bit-identical to the monolithic radix-2 core (the rounding
schedule differs — true for the reference's 2D guidance as well); it is
validated by SNR against the float model and bit-exactly against the
device mesh implementation.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import FFTConfig
from .int_model import cmult_int, fft_int, needs_object
from .twiddle import circle_twiddles_int


def _factor_cfg(cfg: FFTConfig, n: int, data_width: int) -> FFTConfig:
    return dataclasses.replace(cfg, n=n, data_width=data_width)


def four_step_shapes(n1: int, n2: int):
    for f in (n1, n2):
        if f < 8 or f & (f - 1):
            raise ValueError(f"four-step factors must be powers of two >= 8, "
                             f"got {n1}x{n2}")
    return n1 * n2


def twiddle_apply_int(b_re, b_im, m, cfg: FFTConfig, width: int):
    """Multiply B by W_N^m (conjugated when cfg used for inverse is handled
    by the caller negating ``m`` mod N): exact integer cmult with the core's
    renormalizing floor shift, at data width ``width``."""
    n = cfg.n
    w_re, w_im = circle_twiddles_int(n, cfg.twiddle_width, cfg.twiddle_gen)
    if needs_object(cfg):
        w_re, w_im = w_re.astype(object), w_im.astype(object)
    m = np.asarray(m) % n
    return cmult_int(b_re, b_im, w_re[m], w_im[m], cfg.twiddle_shift, width)


def four_step_int(x_re, x_im, cfg: FFTConfig, n1: int, n2: int,
                  inverse: bool = False):
    """Integer four-step transform of size cfg.n = n1*n2.

    x_re, x_im: [..., n] natural order.  Returns (re, im) natural order,
    same contract as ``fft_int`` (unnormalized inverse).
    """
    n = four_step_shapes(n1, n2)
    assert cfg.n == n, f"cfg.n={cfg.n} != n1*n2={n}"
    dt = object if needs_object(cfg) else np.int64
    xr = np.asarray(x_re, dtype=dt)
    xi = np.asarray(x_im, dtype=dt)
    shp = xr.shape[:-1]

    cfg1 = _factor_cfg(cfg, n1, cfg.data_width)
    w1 = cfg1.output_width                    # width after the column pass
    cfg2 = _factor_cfg(cfg, n2, w1)

    # [..., n1, n2] -> column FFTs over n1: transpose to [..., n2, n1]
    a_re = xr.reshape(shp + (n1, n2)).swapaxes(-1, -2)
    a_im = xi.reshape(shp + (n1, n2)).swapaxes(-1, -2)
    b_re, b_im = fft_int(a_re, a_im, cfg1, inverse=inverse)   # [..., n2, k1]

    # inter-factor twiddle W_N^(+-n2*k1)
    n2_idx = np.arange(n2).reshape(n2, 1)
    k1_idx = np.arange(n1).reshape(1, n1)
    m = n2_idx * k1_idx
    if inverse:
        m = (-m) % n
    c_re, c_im = twiddle_apply_int(b_re, b_im, m, cfg, w1)

    # row FFTs over n2 for each k1: transpose to [..., k1, n2]
    c_re = c_re.swapaxes(-1, -2)
    c_im = c_im.swapaxes(-1, -2)
    d_re, d_im = fft_int(c_re, c_im, cfg2, inverse=inverse)   # [..., k1, k2]

    # corner turn: X[k2*N1+k1] = D[k1,k2]
    o_re = d_re.swapaxes(-1, -2).reshape(shp + (n,))
    o_im = d_im.swapaxes(-1, -2).reshape(shp + (n,))
    return o_re, o_im


def four_step_float(x: np.ndarray, n1: int, n2: int,
                    inverse: bool = False) -> np.ndarray:
    """Float four-step — equals numpy fft (unnormalized ifft) exactly."""
    n = four_step_shapes(n1, n2)
    x = np.asarray(x, dtype=np.complex128)
    shp = x.shape[:-1]
    a = x.reshape(shp + (n1, n2)).swapaxes(-1, -2)
    xform = (lambda v: np.fft.ifft(v) * v.shape[-1]) if inverse else np.fft.fft
    b = xform(a)                                            # [..., n2, k1]
    m = (np.arange(n2).reshape(n2, 1) * np.arange(n1).reshape(1, n1)) % n
    sgn = 1j if inverse else -1j
    c = b * np.exp(sgn * 2 * np.pi * m / n)
    d = xform(c.swapaxes(-1, -2))                           # [..., k1, k2]
    return d.swapaxes(-1, -2).reshape(shp + (n,))
