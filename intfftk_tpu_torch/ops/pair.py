"""The FFT -> spectrum product -> IFFT pair on one device.

Counterpart of the reference's ``int_fft_ifft_pair``
(``src/vhdl/main/int_fft_ifft_pair.vhd:87-107``) with a frequency-domain
product between its two cores: the forward core leaves its spectrum in raw
(bit-reversed) order, the product multiplies it by a spectrum table held in
that same order, and the inverse core, whose input width is the forward's
output width (``:261``), takes the raw order back to natural order.  No
reorder exists anywhere on the chain.

On the card a call is the forward's ``PreparedChain`` (two launches of the
pass), one ``PreparedProduct`` (P1, ``csrc/product.cu``) that writes the
inverse's input dtype itself, and the inverse's ``PreparedChain``: five
launches and no torch kernel where the forward's output and the inverse's
input are int32 or int64 blocks.  On the CPU the plain versions run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import FFTConfig
from ..device import resolve, use_kernel
from ..runtime import trace
from .fused_fft import LargeFFTPlan, PreparedPlan
from .intmath import PreparedProduct, spectrum_product


class FFTPairPlan(PreparedPlan):
    """``cfg``'s forward transform, the product with ``spectrum``, and the
    inverse transform, on [B, *block_in_shape] blocks.

    The forward is ``LargeFFTPlan(cfg, n1, n2, order="raw")`` (``factors``
    = (n1, n2), else that plan's default split); the inverse is
    ``LargeFFTPlan(icfg, n2, n1, inverse=True, order="raw")`` with
    ``icfg`` = ``cfg`` at ``data_width = cfg.output_width`` in
    ``inverse_mode`` / ``inverse_rounding``.  ``spectrum`` is (hr, hi):
    integers of natural frequency order, length n, at most
    ``spectrum_width`` <= 27 bits (else ValueError); they are permuted once
    by ``fwd.raw_spectrum_order()`` into ``fwd.block_out_shape`` and held
    as the int32 buffers ``hr``/``hi`` on ``device`` (the current CUDA
    device unless the caller names one; ``device="cpu"`` for the CPU).
    The product is ``(f * h) >> product_shift`` wrapped to the inverse's
    data width, ``product_width``.

    A call takes re and im blocks [B, *fwd.block_in_shape] in
    ``fwd.in_dtype`` (a flat natural-order frame reshaped) and returns the
    inverse's blocks of the same shape in ``inv.out_dtype``, whose flat
    view is natural order."""

    @trace.spanned("plan.build")
    def __init__(self, cfg: FFTConfig, spectrum, *,
                 inverse_mode: str = "scaled",
                 inverse_rounding: str = "round", product_shift: int,
                 spectrum_width: int, factors=None,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve(device)
        n1, n2 = (None, None) if factors is None else factors
        self.fwd = LargeFFTPlan(cfg, n1, n2, order="raw", device=device)
        icfg = dataclasses.replace(cfg, mode=inverse_mode,
                                   rounding=inverse_rounding,
                                   data_width=cfg.output_width)
        self.inv = LargeFFTPlan(icfg, self.fwd.n2, self.fwd.n1, inverse=True,
                                order="raw", device=device)
        bo = self.fwd.block_out_shape
        assert self.inv.block_in_shape == bo
        if not 1 <= spectrum_width <= 27:
            raise ValueError(f"spectrum_width {spectrum_width} outside "
                             f"1..27")
        lim = 1 << (spectrum_width - 1)
        perm = self.fwd.raw_spectrum_order()
        for name, h in zip(("hr", "hi"), spectrum):
            h = np.asarray(h.cpu() if torch.is_tensor(h) else h)
            if h.shape != (cfg.n,) or h.dtype.kind not in "iu":
                raise ValueError(f"spectrum {name}: expected {cfg.n} "
                                 f"integers, got {h.dtype} {h.shape}")
            if h.size and (h.min() < -lim or h.max() >= lim):
                raise ValueError(f"spectrum {name} is wider than "
                                 f"{spectrum_width} bits")
            self.register_buffer(name, torch.as_tensor(
                h[perm].reshape(bo).astype(np.int32), device=device))
        self.product_shift = product_shift
        self.spectrum_width = spectrum_width
        self.product_width = icfg.data_width

    def _product(self, fr, fi):
        """P1 into the inverse's input dtype: on the card one prepared
        launch per (shape, dtype, device); the kernel takes int32 or int64
        and writes int32 or int64, so int16 blocks are cast either side."""
        if fr.dtype == torch.int16:
            fr, fi = fr.int(), fi.int()
        want = self.inv.in_dtype
        out = torch.int32 if want == torch.int16 else want
        args = (self.hr, self.hi, self.product_shift, self.product_width,
                self.spectrum_width, out)
        if use_kernel(fr.device):
            key = (fr.shape, fr.dtype, fr.device, "product")
            pr, pi = self._prepare(key, lambda: PreparedProduct(
                fr, fi, *args))(fr, fi)
        else:
            pr, pi = spectrum_product(fr, fi, *args)
        return (pr, pi) if out == want else (pr.to(want), pi.to(want))

    def forward(self, x_re, x_im):
        """[B, *fwd.block_in_shape] blocks in ``fwd.in_dtype`` -> the
        inverse's [B, *fwd.block_in_shape] blocks in ``inv.out_dtype``."""
        want = (self.fwd.in_dtype, self.fwd.block_in_shape)
        for x in (x_re, x_im):
            if (x.dtype, tuple(x.shape[1:])) != want or x.dim() != 3:
                raise ValueError(f"expected [B, {want[1][0]}, {want[1][1]}] "
                                 f"{want[0]} blocks, got {x.dtype} "
                                 f"{tuple(x.shape)}")
        fr, fi = self.fwd.apply_blocks(x_re, x_im)
        return self.inv.apply_blocks(*self._product(fr, fi))

    def capture(self):
        """``runtime.graph.captured(self)``: the whole chain replayed from
        one CUDA graph per input (shape, dtype, device).  Its outputs are
        static (see ``CapturedCall``); a ``retune`` of either plan and
        ``.to()`` drop its graphs."""
        from ..runtime.graph import captured

        call = self._track(captured(self))
        for plan in (self.fwd, self.inv):
            plan._track(call)
        return call
