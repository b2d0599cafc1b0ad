"""Overlap-save FFT convolution on one device.

Counterpart of ``intfftk_tpu/parallel/convolve.py`` (BASELINE config 4): a
long signal is cut into blocks of n = L + M - 1 samples, each block the L
new samples after the M - 1 that precede them; every block runs the exact
integer pipeline of the host oracle ``golden.convolve.overlap_save_int``
(forward unscaled block FFT, renormalised frequency product, scaled inverse
FFT, cut of the first M - 1 samples) and the result is bit-identical to it.

The JAX class also shards the signal over a mesh axis and fetches each
shard's halo from its neighbour with ``ppermute`` (:203-210).  That waits
for the ``torch.distributed`` slice: there is no ``mesh`` argument here
yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve, use_kernel
from ..golden.convolve import ConvSpec, taps_spectrum_int
from ..ops.fused_fft import LargeFFTPlan, fused_pass
from ..ops.intmath import spectrum_product
from .four_step import local_plan


class OverlapSaveConv(nn.Module):
    """Streaming integer FIR convolution by overlap-save.

    taps: integer arrays (h_re, h_im) of length ``spec.taps_len``.  The
    taps spectrum is built on the host (exact integer FFT,
    ``taps_spectrum_int``) and held as buffers ``hr``/``hi`` on ``device``
    (the current CUDA device unless the caller names one; ``device="cpu"``
    for the CPU).

    Block transforms, by ``kernel`` (the names of ``resolve_kernel``):

    * "pallas" (and "auto"): the CUDA kernel, its plain version on the CPU:
      a ``FusedAxisFFT`` pair for n <= 4096, one launch each; where
      ``spec.factors`` is set (the 64k-block / 8k-tap scale), a raw-order
      ``LargeFFTPlan`` pair, the forward then the swapped-factor inverse,
      two launches each.  The chain stays in block layout from the forward
      through the product into the inverse: the taps spectrum is permuted
      once by ``raw_spectrum_order()`` into the forward's
      ``block_out_shape``, which is the inverse's ``block_in_shape``, so
      no reorder exists on the spectrum side;
    * "xla": the staged ``FFTPlan`` pair, on the CPU only.

    The frequency product is ``intmath.spectrum_product``: one launch of
    the product kernel on the card, its plain version on the CPU (in JAX
    it is XLA arithmetic inside the chain's jit, outside any Pallas
    kernel).  It writes the inverse's input dtype itself.  A product wider
    than 32 bits (``spec.product_width``) needs the four-step engine; its
    inverse runs on int64 blocks.

    Call with x_re, x_im of shape [..., T], T a multiple of
    ``spec.payload`` (pad on the host; ``golden.convolve`` documents the
    semantics).  Returns the first T samples of the causal linear
    convolution, scaled by 2^-``spec.scale_log2``: int32, or int64 when
    the product is wide.
    """

    def __init__(self, spec: ConvSpec, h_re, h_im, kernel: str = "auto",
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve(device)
        self.spec = spec
        hr, hi = taps_spectrum_int(np.asarray(h_re), np.asarray(h_im), spec)
        if kernel == "auto":
            kernel = "pallas"
        if kernel not in ("pallas", "xla"):
            raise ValueError(f"bad kernel {kernel!r}")
        if kernel == "xla" and use_kernel(device):
            raise NotImplementedError(
                "the staged path runs on the CPU only: on the card every "
                "transform goes through a kernel")
        self.kernel = kernel
        #: products wider than 32 bits run the inverse on int64 blocks
        #: (higher SNR at large n/taps: less renormalising downshift)
        self.wide = spec.product_width > 32
        self.large = kernel == "pallas" and spec.factors is not None
        if self.wide and not self.large:
            raise NotImplementedError(
                "products wider than 32 bits need the four-step pallas "
                "engine (spec.factors set, kernel='pallas')")
        if self.large:
            n1, n2 = spec.factors
            self.fwd = LargeFFTPlan(spec.fft_cfg, n1, n2, order="raw",
                                    device=device)
            self.inv = LargeFFTPlan(spec.ifft_cfg, n2, n1, inverse=True,
                                    order="raw", device=device)
            bo = self.fwd.block_out_shape
            assert self.inv.block_in_shape == bo
            perm = self.fwd.raw_spectrum_order()
            hr, hi = hr[perm].reshape(bo), hi[perm].reshape(bo)
        else:
            self.fwd = local_plan(spec.fft_cfg, False, kernel, device)
            self.inv = local_plan(spec.ifft_cfg, True, kernel, device)
        self.out_dtype = torch.int64 if self.wide else torch.int32
        for name, h in (("hr", hr), ("hi", hi)):
            self.register_buffer(name, torch.as_tensor(
                h.astype(np.int32), device=device))

    def _blocks(self, xr, xi, pass_fn, product_fn):
        """[..., T] on the device -> the conv chunk [..., T]."""
        spec = self.spec
        n, m, lpay = spec.n, spec.taps_len, spec.payload
        t = xr.shape[-1]
        shp = xr.shape[:-1]

        def windows(x):
            # [..., M-1 zeros | T] -> overlapping [rows, nb, n]: one
            # strided view, one contiguous copy (no index gather)
            e = torch.nn.functional.pad(x.reshape(-1, t), (m - 1, 0))
            return e.unfold(-1, n, lpay)

        def product(fr, fi):
            # int32 or int64 in (an int16 forward widens first), the
            # inverse's input dtype out unless that is int16
            if fr.dtype == torch.int16:
                fr, fi = fr.int(), fi.int()
            return product_fn(
                fr.contiguous(), fi.contiguous(), self.hr, self.hi,
                spec.product_shift, spec.product_width, spec.spectrum_width,
                self.out_dtype)

        def cut(y):
            return y.reshape(shp + (-1, n))[..., m - 1:].reshape(
                shp + (t,)).to(self.out_dtype)

        br, bi = windows(xr), windows(xi)
        if self.large:
            blk = lambda b: b.reshape((-1,) + self.fwd.block_in_shape).to(
                self.fwd.in_dtype).contiguous()
            fr, fi = self.fwd.apply_blocks(blk(br), blk(bi), pass_fn=pass_fn)
            pr, pi = product(fr, fi)
            yr, yi = self.inv.apply_blocks(pr.to(self.inv.in_dtype),
                                           pi.to(self.inv.in_dtype),
                                           pass_fn=pass_fn)
        else:
            fr, fi = self.fwd(br, bi)
            yr, yi = self.inv(*product(fr, fi))
        return cut(yr), cut(yi)

    def forward(self, x_re, x_im, pass_fn=fused_pass,
                product_fn=spectrum_product):
        """Integer [..., T] (tensors or arrays) -> (y_re, y_im) [..., T] on
        this module's device.  ``pass_fn=fused_pass_reference`` and
        ``product_fn=spectrum_product_reference`` run the plain versions of
        the four-step engine and of the product on any device."""
        dev = self.hr.device
        xr = torch.as_tensor(x_re).to(device=dev, dtype=torch.int32)
        xi = torch.as_tensor(x_im).to(device=dev, dtype=torch.int32)
        t = xr.shape[-1]
        if t % self.spec.payload:
            raise ValueError(f"signal length {t} must be a multiple of "
                             f"payload = {self.spec.payload} (pad "
                             f"host-side)")
        return self._blocks(xr, xi, pass_fn, product_fn)
