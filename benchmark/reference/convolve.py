"""Overlap-save streaming FFT convolution — golden host model.

The streaming-convolution capability layered on the FFT cores (SURVEY §2.8:
the halo-exchange/"ring" communication shape of the framework).  The
reference provides the transform engine; frequency-domain filtering is the
canonical composition of it, and the one that exercises neighbor-exchange
parallelism (each signal block needs the tail of its predecessor).

Numeric scheme (all-integer, widths static):

1. taps -> spectrum: exact unscaled integer FFT of the zero-padded taps
   (bit growth log2 n), optionally floor-shifted down by ``taps_shift`` to a
   manageable width,
2. per block: unscaled integer FFT of [prev tail | payload] (n = L + M - 1),
3. frequency product with renormalizing floor-shift ``product_shift``
   (same slice semantics as the core's twiddle multiply,
   ``int_cmult_dsp48.vhd:189-190``),
4. scaled (1/n) integer IFFT, discard the first M-1 aliased samples.

Output y[t] = (x * h)[t] scaled by 2^-(taps_shift + product_shift); the
exact scale is returned so callers can renormalize.  The device mesh
implementation (``parallel.convolve``) computes identical integers.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .config import FFTConfig
from .int_model import cmult_int, fft_int, wrap_width


def _block_fft(x_re, x_im, cfg, spec, inverse=False):
    """Block transform of the spec's engine: monolithic radix-2, or the
    four-step composition when ``spec.factors`` is set."""
    if spec.factors is None:
        return fft_int(x_re, x_im, cfg, inverse=inverse)
    from .four_step import four_step_int
    n1, n2 = spec.factors if not inverse else spec.factors[::-1]
    return four_step_int(x_re, x_im, cfg, n1, n2, inverse=inverse)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Static plan of one overlap-save convolution."""

    cfg: FFTConfig              # block FFT config (n, widths; mode forced)
    taps_len: int               # M
    taps_width: int             # bits of the integer taps
    taps_shift: int             # pre-shift of the taps spectrum
    product_shift: int          # renormalizing shift of the freq product
    rounding: str = "truncate"  # IFFT scaled rounding
    #: When set, block transforms use the four-step decomposition
    #: n = factors[0] * factors[1] (the engine for blocks beyond the fused
    #: kernel's single-pass row budget).  The width/growth contract is
    #: identical; the rounding schedule differs from the monolithic core,
    #: so the golden model composes the same decomposition.
    factors: tuple | None = None

    @property
    def n(self) -> int:
        return self.cfg.n

    @property
    def payload(self) -> int:
        """L: new samples consumed/produced per block."""
        return self.n - self.taps_len + 1

    @property
    def fft_cfg(self) -> FFTConfig:
        """Forward block transform: unscaled (exact growth)."""
        return dataclasses.replace(self.cfg, mode="unscaled")

    @property
    def spectrum_width(self) -> int:
        """Width of the (shifted) taps spectrum."""
        return self.taps_width + self.cfg.stages - self.taps_shift

    @property
    def product_width(self) -> int:
        w = (self.fft_cfg.output_width + self.spectrum_width + 1
             - self.product_shift)
        return w

    @property
    def ifft_cfg(self) -> FFTConfig:
        return dataclasses.replace(self.cfg, mode="scaled",
                                   rounding=self.rounding,
                                   data_width=self.product_width)

    @property
    def scale_log2(self) -> int:
        """Output = conv(x, h) * 2^-scale_log2 (up to rounding noise)."""
        return self.taps_shift + self.product_shift


def make_conv_spec(n: int, taps_len: int, data_width: int = 16,
                   taps_width: int = 16, twiddle_width: int = 20,
                   max_spectrum_width: int = 18,
                   rounding: str = "truncate",
                   factors: tuple | None = None,
                   max_product_width: int = 32) -> ConvSpec:
    """Pick shifts so every intermediate fits the device path.

    Default twiddle width 20: a unity-gain configuration (the reference's
    w=18 magnitude/shift mismatch halves data per multiply stage — see
    docs/numerics.md "The w = 18 edge").

    ``factors``: four-step block-transform split; defaults to the balanced
    split whenever n exceeds the fused kernel's single-pass row budget
    (4096) so the device path stays on the two-pass fused pipeline.

    ``max_product_width``: width budget of the frequency product / IFFT
    path.  32 keeps everything on native int32; up to 52 runs the product
    and inverse on the wide limb-plane kernels (the double/triple-DSP tier
    analog) — the large-n/long-taps fidelity lever: every bit here is one
    bit less renormalizing downshift, ~6 dB of output SNR.
    """
    if taps_len >= n:
        raise ValueError(f"taps ({taps_len}) must be shorter than n ({n})")
    if not (18 <= max_product_width <= 52):
        raise ValueError(f"max_product_width must be in [18, 52]")
    cfg = FFTConfig(n=n, mode="unscaled", data_width=data_width,
                    twiddle_width=twiddle_width)
    stages = cfg.stages
    if cfg.output_width > 32:
        # the conv engine's wide limb-plane path covers wide *products*
        # (the IFFT side); wide forward-block *spectra* are not plumbed —
        # fail here with the width arithmetic instead of an opaque
        # unpack error at trace time inside the raw-order chain
        raise ValueError(
            f"forward block spectrum is {cfg.output_width} bits "
            f"(data_width {data_width} + log2(n) {stages}) > 32; reduce "
            f"data_width to <= {32 - stages} for n={n}, or shorten the "
            f"block FFT")
    if factors is None and n > 4096:
        l2 = max(7, stages // 2)
        factors = (n >> l2, 1 << l2)
    w_h_full = taps_width + stages
    taps_shift = max(0, w_h_full - max_spectrum_width)
    w_x = data_width + stages
    w_h = w_h_full - taps_shift
    product_shift = max(0, w_x + w_h + 1 - max_product_width)
    spec = ConvSpec(cfg=cfg, taps_len=taps_len, taps_width=taps_width,
                    taps_shift=taps_shift, product_shift=product_shift,
                    rounding=rounding, factors=factors)
    if spec.product_width > 32 and factors is None:
        raise ValueError("products wider than 32 bits need the four-step "
                         "engine: pass factors (or use n > 4096) or reduce "
                         "widths")
    return spec


def taps_spectrum_int(h_re, h_im, spec: ConvSpec):
    """Integer spectrum of the taps: exact unscaled FFT, floor-shifted."""
    m = spec.taps_len
    assert len(h_re) == m
    pad = np.zeros(spec.n, dtype=np.int64)
    hr, hi = pad.copy(), pad.copy()
    hr[:m], hi[:m] = h_re, h_im
    taps_cfg = dataclasses.replace(spec.fft_cfg, data_width=spec.taps_width)
    sr, si = _block_fft(hr, hi, taps_cfg, spec)
    return sr >> spec.taps_shift, si >> spec.taps_shift


def overlap_save_int(x_re, x_im, h_re, h_im, spec: ConvSpec):
    """Streaming integer convolution of x (length T) with taps h (length M).

    Returns (y_re, y_im) of length ceil(T / L) * L  — the first samples of
    the causal linear convolution, scaled by 2^-spec.scale_log2.
    """
    n, m, lpay = spec.n, spec.taps_len, spec.payload
    hr, hi = taps_spectrum_int(h_re, h_im, spec)

    xr = np.asarray(x_re, dtype=np.int64)
    xi = np.asarray(x_im, dtype=np.int64)
    t = xr.shape[-1]
    nblocks = -(-t // lpay)
    pad = nblocks * lpay - t
    shp = xr.shape[:-1]
    if pad:
        z = np.zeros(shp + (pad,), dtype=np.int64)
        xr, xi = np.concatenate([xr, z], -1), np.concatenate([xi, z], -1)
    zh = np.zeros(shp + (m - 1,), dtype=np.int64)
    er, ei = np.concatenate([zh, xr], -1), np.concatenate([zh, xi], -1)

    # overlapping block windows [nblocks, n]
    idx = (np.arange(nblocks)[:, None] * lpay + np.arange(n)[None, :])
    br, bi = er[..., idx], ei[..., idx]

    fr, fi = _block_fft(br, bi, spec.fft_cfg, spec)
    pr, pi = cmult_int(fr, fi, hr, hi, spec.product_shift,
                       spec.product_width)
    yr, yi = _block_fft(pr, pi, spec.ifft_cfg, spec, inverse=True)
    # discard the M-1 aliased head samples of each block
    yr = yr[..., m - 1:].reshape(shp + (nblocks * lpay,))
    yi = yi[..., m - 1:].reshape(shp + (nblocks * lpay,))
    return yr, yi
