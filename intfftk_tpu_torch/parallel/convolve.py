"""Overlap-save FFT convolution, on one device or sharded over a mesh axis.

Counterpart of ``intfftk_tpu/parallel/convolve.py`` (BASELINE config 4): a
long signal is cut into blocks of n = L + M - 1 samples, each block the L
new samples after the M - 1 that precede them; every block runs the exact
integer pipeline of the host oracle ``golden.convolve.overlap_save_int``
(forward unscaled block FFT, renormalised frequency product, scaled inverse
FFT, cut of the first M - 1 samples) and the result is bit-identical to it.

With a ``mesh`` the signal is split contiguously over its ``axis`` (SPMD:
each rank holds [..., T/D]) and each rank takes the M - 1 samples before
its chunk from its left neighbour, the halo of ``:203-210``: every rank
sends its last M - 1 samples to rank + 1 (``dist.batch_isend_irecv`` on
the axis's group) and rank 0 receives zeros.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..device import use_kernel
from ..golden.convolve import ConvSpec, taps_spectrum_int
from ..ops.fused_fft import LargeFFTPlan, fused_pass
from ..ops.intmath import spectrum_product
from .four_step import local_plan
from .mesh import FFT_AXIS, plan_device, single_axis_size


def halo_exchange(tails, group, rank: int, size: int):
    """Every rank's ``tails`` (tensors) to rank + 1 of ``group``, in one
    ``dist.batch_isend_irecv``: returns what arrived from rank - 1, zeros on
    rank 0."""
    heads = [torch.zeros_like(t) for t in tails]
    peer = lambda r: dist.get_global_rank(group, r)
    ops = []
    if rank + 1 < size:
        ops += [dist.P2POp(dist.isend, t, peer(rank + 1), group)
                for t in tails]
    if rank > 0:
        ops += [dist.P2POp(dist.irecv, h, peer(rank - 1), group)
                for h in heads]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return heads


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
    the product is wide.  With ``mesh``, the call takes and returns this
    rank's contiguous chunk [..., T/D] of a signal split over ``axis``;
    T must be a multiple of payload * D, and each chunk at least M - 1
    samples long; the device is the mesh's unless named.
    """

    def __init__(self, spec: ConvSpec, h_re, h_im, kernel: str = "auto",
                 device: torch.device | str | None = None,
                 mesh: DeviceMesh | None = None, axis: str = FFT_AXIS):
        super().__init__()
        device = plan_device(mesh, device)
        self.spec = spec
        self.mesh, self.axis = mesh, axis
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

    def _blocks(self, xr, xi, pass_fn, product_fn, heads=None):
        """[..., T] on the device (and the M - 1 samples before each row,
        [rows, M - 1], or None for zeros) -> the conv chunk [..., T]."""
        spec = self.spec
        n, m, lpay = spec.n, spec.taps_len, spec.payload
        t = xr.shape[-1]
        shp = xr.shape[:-1]

        def windows(x, head):
            # [..., M-1 before | T] -> overlapping [rows, nb, n]: one
            # strided view, one contiguous copy (no index gather)
            x = x.reshape(-1, t)
            e = (torch.nn.functional.pad(x, (m - 1, 0)) if head is None
                 else torch.cat([head, x], -1))
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

        hr, hi = (None, None) if heads is None else heads
        br, bi = windows(xr, hr), windows(xi, hi)
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
        t, lpay = xr.shape[-1], self.spec.payload
        if self.mesh is None:
            if t % lpay:
                raise ValueError(f"signal length {t} must be a multiple of "
                                 f"payload = {lpay} (pad host-side)")
            return self._blocks(xr, xi, pass_fn, product_fn)
        d = single_axis_size(self.mesh, self.axis)
        if t % lpay:
            raise ValueError(f"signal length {t * d} must be a multiple of "
                             f"payload*devices = {lpay * d} (pad host-side)")
        m = self.spec.taps_len
        if t < m - 1:
            raise ValueError(f"a chunk of {t} samples holds less than the "
                             f"{m - 1} of the halo")
        tails = [x.reshape(-1, t)[:, t - (m - 1):].contiguous()
                 for x in (xr, xi)]
        heads = halo_exchange(tails, self.mesh.get_group(self.axis),
                              self.mesh.get_local_rank(self.axis), d)
        return self._blocks(xr, xi, pass_fn, product_fn, heads)
