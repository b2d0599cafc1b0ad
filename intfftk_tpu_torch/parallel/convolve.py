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
from ..ops.fused_fft import Edges, PreparedPlan
from ..ops.pair import FFTPairPlan, product_step
from ..runtime import trace
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


class OverlapSaveConv(PreparedPlan):
    """Streaming integer FIR convolution by overlap-save.

    taps: integer arrays (h_re, h_im) of length ``spec.taps_len``.  The
    taps spectrum is built on the host (exact integer FFT,
    ``taps_spectrum_int``) and held on ``device`` (the current CUDA device
    unless the caller names one; ``device="cpu"`` for the CPU).

    Block transforms, by ``kernel`` (the names of ``resolve_kernel``):

    * "pallas" (and "auto"): the CUDA kernel, its plain version on the CPU:
      where ``spec.factors`` is set (the 64k-block / 8k-tap scale), an
      ``FFTPairPlan`` (``pair``) of ``spec.fft_cfg``, the taps spectrum and
      ``spec.ifft_cfg``'s inverse: the raw-order four-step forward (two
      launches), the product (one) and the swapped-factor inverse (two),
      with the windows before it and the cut after it; without a ``mesh``,
      where the lead M - 1 and the payload are whole rows of the
      transforms' blocks, the chain's first load reads the windows from
      the signal and its last store writes the cut (``Edges``,
      ``FFTPairPlan.edge_sides``, ``edges``): then nothing but the five
      launches runs between a call's input and its output; for n <= 4096 a
      ``FusedAxisFFT`` pair (``fwd``, ``inv``), one launch each, with the
      spectrum in natural order (``hr``, ``hi``);
    * "xla": the staged ``FFTPlan`` pair, on the CPU only.

    The frequency product is ``ops.pair.product_step`` either way: one
    launch of the product kernel on the card, its plain version on the CPU
    (in JAX it is XLA arithmetic inside the chain's jit, outside any Pallas
    kernel).  A product wider than 32 bits (``spec.product_width``) needs
    the four-step engine; its inverse runs on int64 blocks.

    Call with x_re, x_im of shape [..., T], T a multiple of
    ``spec.payload`` (pad on the host; ``golden.convolve`` documents the
    semantics).  Returns the first T samples of the causal linear
    convolution, scaled by 2^-``spec.scale_log2``: int32, or int64 when
    the product is wide.  With ``mesh``, the call takes and returns this
    rank's contiguous chunk [..., T/D] of a signal split over ``axis``;
    T must be a multiple of payload * D, and each chunk at least M - 1
    samples long; the device is the mesh's unless named.

    ``edges``: the sides of the chain that read and write the signal in
    place ("window", "cut"), () where torch's windows and cut run (a
    ``mesh``, whose heads come from a neighbour; the single-pass engine; a
    lead or payload of no whole rows).  While a recording is open the
    ``plan.build`` span notes them, "edges window cut" or "edges none".
    """

    @trace.spanned("plan.build")
    def __init__(self, spec: ConvSpec, h_re, h_im,
                 mesh: DeviceMesh | None = None, axis: str = FFT_AXIS,
                 kernel: str = "auto",
                 device: torch.device | str | None = None):
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
        self.out_dtype = torch.int64 if self.wide else torch.int32
        if self.large:
            self.pair = FFTPairPlan(
                spec.fft_cfg, (hr, hi), inverse_mode="scaled",
                inverse_rounding=spec.rounding,
                product_shift=spec.product_shift,
                spectrum_width=spec.spectrum_width,
                product_width=spec.product_width, factors=spec.factors,
                device=device)
        else:
            self.fwd = local_plan(spec.fft_cfg, False, kernel, device)
            self.inv = local_plan(spec.ifft_cfg, True, kernel, device)
            for name, h in (("hr", hr), ("hi", hi)):
                self.register_buffer(name, torch.as_tensor(
                    h.astype(np.int32), device=device))
        self.edges = (self.pair.edge_sides(spec.payload, spec.taps_len - 1)
                      if self.large and mesh is None else ())
        trace.note("edges " + (" ".join(self.edges) or "none"))

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

        def trim(y):
            return y.reshape(shp + (-1, n))[..., m - 1:].reshape(
                shp + (t,)).to(self.out_dtype)

        hr, hi = (None, None) if heads is None else heads
        if self.large:
            # the chain reads the windows from the signal and writes the
            # cut in place where it takes those edges (never on a mesh)
            edges = Edges(lpay, m - 1, t)
            window, cut = (edges if side in self.edges else None
                           for side in ("window", "cut"))
            fwd = self.pair.fwd
            # temporaries go straight to the pair, which drops them once
            # the forward has read them
            src = ((lambda x, h: x.reshape(-1, t)) if window else
                   lambda x, h: windows(x, h).reshape(
                       (-1,) + fwd.block_in_shape).to(
                           fwd.in_dtype).contiguous())
            yr, yi = self.pair.apply_blocks(src(xr, hr), src(xi, hi),
                                            pass_fn, product_fn,
                                            window=window, cut=cut)
            if cut:
                return yr.reshape(shp + (t,)), yi.reshape(shp + (t,))
        else:
            br, bi = windows(xr, hr), windows(xi, hi)
            fr, fi = self.fwd(br, bi)
            yr, yi = self.inv(*product_step(
                self, fr, fi, self.hr, self.hi, spec.product_shift,
                spec.product_width, spec.spectrum_width, self.out_dtype,
                product_fn))
        return trim(yr), trim(yi)

    def forward(self, x_re, x_im, pass_fn=None, product_fn=None):
        """Integer [..., T] (tensors or arrays) -> (y_re, y_im) [..., T] on
        this module's device.  On the card the four-step engine's passes
        go out as its plans' prepared chains and the product as P1's
        prepared launch (prepared at the first call with a shape);
        ``pass_fn`` and ``product_fn`` run them one call each instead, as
        ``FFTPairPlan.apply_blocks`` takes them (the single-pass engines
        take ``product_fn`` only)."""
        dev = (self.pair if self.large else self).hr.device
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

    def capture(self):
        """``runtime.graph.captured(self)``: the whole call (windows, both
        transforms, the product, the cut) replayed from one CUDA graph per
        input (shape, dtype, device), the port's counterpart of the JAX
        module's ``jax.jit``.  It takes CUDA tensors only (an array or a
        CPU tensor would be a host copy inside the graph: it raises), and
        not with a ``mesh`` (its halo exchange is a collective).  Its
        outputs are static: each call overwrites the previous call's
        outputs of the same key (see ``CapturedCall``).  A ``retune`` of
        either transform's plan and ``.to()`` drop its graphs."""
        from ..runtime.graph import captured

        if self.mesh is not None:
            raise NotImplementedError("a convolution over a mesh exchanges "
                                      "halos between calls: no capture")
        return self._track(captured(self))
