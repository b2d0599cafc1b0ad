"""Stimulus generation (analog of ``reference/math/fft_single.m``).

The reference drives its testbenches with an amplitude-windowed chirp plus
AWGN quantized to the input width (``fft_single.m:93-98``,
``test_fft_radix2.m:40-75``).  Same recipe here, deterministic.
"""

from __future__ import annotations

import numpy as np


def chirp_stimulus(n: int, data_width: int, f_sig: float = 24.0,
                   beta: float = 0.95, snr_db: float = 50.0,
                   seed: int = 1):
    """Windowed complex chirp + AWGN, quantized to ``data_width`` bits.

    Returns (re, im) int64 in [-2^(w-1), 2^(w-1)).
    """
    amp = float((1 << (data_width - 1)) - 1) * 0.5
    i = np.arange(n, dtype=np.float64)
    phase = (f_sig * i + beta * i * i / 2.0) * 2.0 * np.pi / n
    win = np.sin(i * np.pi / n)
    re = amp * np.cos(phase) * win
    im = amp * np.sin(phase) * win
    rng = np.random.default_rng(seed)
    p_sig = np.mean(re**2 + im**2)
    sigma = np.sqrt(p_sig * 10.0 ** (-snr_db / 10.0) / 2.0)
    re = re + rng.normal(scale=sigma, size=n)
    im = im + rng.normal(scale=sigma, size=n)
    lo, hi = -(1 << (data_width - 1)), (1 << (data_width - 1)) - 1
    return (np.clip(np.round(re), lo, hi).astype(np.int64),
            np.clip(np.round(im), lo, hi).astype(np.int64))


def random_stimulus(n: int, data_width: int, seed: int = 0, batch=()):
    """Uniform full-scale random integers — worst case for bit growth."""
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (data_width - 1)), (1 << (data_width - 1))
    shape = tuple(batch) + (n,)
    return (rng.integers(lo, hi, shape).astype(np.int64),
            rng.integers(lo, hi, shape).astype(np.int64))
