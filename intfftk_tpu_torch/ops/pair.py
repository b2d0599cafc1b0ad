"""The FFT -> spectrum product -> IFFT pair on one device.

Counterpart of the reference's ``int_fft_ifft_pair``
(``src/vhdl/main/int_fft_ifft_pair.vhd:87-107``) with a frequency-domain
product between its two cores: the forward core leaves its spectrum in raw
(bit-reversed) order, the product multiplies it by a spectrum table held in
that same order, and the inverse core, whose input width is by default the
forward's output width (``:261``), takes the raw order back to natural
order.  No reorder exists anywhere on the chain.

On the card a call is the forward's ``PreparedChain`` (two launches of the
pass), one ``PreparedProduct`` (P1, ``csrc/product.cu``) that writes the
inverse's input dtype itself, and the inverse's ``PreparedChain``: five
launches and no torch kernel where the forward's output and the inverse's
input are int32 or int64 blocks.  Given the convolution's edges
(``fused_fft.Edges``), the forward's first pass reads the signal itself
and the inverse's last pass writes the output itself: no torch kernel
around the chain either.  On the CPU the plain versions run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import FFTConfig
from ..device import resolve, use_kernel
from ..runtime import trace
from .fused_fft import Edges, LargeFFTPlan, PreparedPlan
from .intmath import PreparedProduct, spectrum_product


def product_step(plan: PreparedPlan, fr, fi, hr, hi, shift: int,
                 width: int, spectrum_width: int, want: torch.dtype,
                 product_fn=None):
    """P1, the port's one spectrum product step: ``(f * h) >> shift``
    wrapped to ``width`` bits, returned in ``want``.  The kernel takes
    int32 or int64 and writes int32 or int64, so int16 data is widened
    first, and where ``want`` is int16 it writes int32, then casts.  On the
    card with no ``product_fn``: one ``PreparedProduct`` launch, prepared
    by ``plan`` once per (shape, dtype, device); otherwise ``product_fn or
    spectrum_product`` with ``spectrum_product``'s arguments."""
    if fr.dtype == torch.int16:
        fr, fi = fr.int(), fi.int()
    fr, fi = fr.contiguous(), fi.contiguous()
    out = torch.int32 if want == torch.int16 else want
    args = (hr, hi, shift, width, spectrum_width, out)
    if product_fn is None and use_kernel(fr.device):
        key = (fr.shape, fr.dtype, fr.device, "product")
        pr, pi = plan._prepare(key, lambda: PreparedProduct(
            fr, fi, *args))(fr, fi)
    else:
        pr, pi = (product_fn or spectrum_product)(fr, fi, *args)
    return (pr, pi) if out == want else (pr.to(want), pi.to(want))


class FFTPairPlan(PreparedPlan):
    """``cfg``'s forward transform, the product with ``spectrum``, and the
    inverse transform, on [B, *block_in_shape] blocks: the port's one
    four-step FFT -> P1 -> IFFT chain (``OverlapSaveConv`` runs it between
    its windows and its cut, or hands it those as ``Edges``).

    The forward is ``LargeFFTPlan(cfg, n1, n2, order="raw")`` (``factors``
    = (n1, n2), else that plan's default split); the inverse is
    ``LargeFFTPlan(icfg, n2, n1, inverse=True, order="raw")`` with
    ``icfg`` = ``cfg`` at ``data_width = product_width`` in
    ``inverse_mode`` / ``inverse_rounding``; ``product_width`` is
    ``cfg.output_width`` unless the caller names it.  ``spectrum`` is
    (hr, hi): integers of natural frequency order, length n, at most
    ``spectrum_width`` <= 27 bits (else ValueError); they are permuted once
    by ``fwd.raw_spectrum_order()`` into ``fwd.block_out_shape`` and held
    as the int32 buffers ``hr``/``hi`` on ``device`` (the current CUDA
    device unless the caller names one; ``device="cpu"`` for the CPU).
    ``product`` forms ``(f * h) >> product_shift`` wrapped to
    ``product_width`` bits.

    ``apply_blocks`` takes re and im blocks [B, *fwd.block_in_shape] in
    ``fwd.in_dtype`` (a flat natural-order frame reshaped) and returns the
    inverse's blocks of the same shape in ``inv.out_dtype``, whose flat
    view is natural order; a call does the same after checking its
    input."""

    @trace.spanned("plan.build")
    def __init__(self, cfg: FFTConfig, spectrum, *,
                 inverse_mode: str = "scaled",
                 inverse_rounding: str = "round", product_shift: int,
                 spectrum_width: int, factors=None,
                 device: torch.device | str | None = None,
                 product_width: int | None = None):
        super().__init__()
        device = resolve(device)
        n1, n2 = (None, None) if factors is None else factors
        self.fwd = LargeFFTPlan(cfg, n1, n2, order="raw", device=device)
        icfg = dataclasses.replace(
            cfg, mode=inverse_mode, rounding=inverse_rounding,
            data_width=product_width or cfg.output_width)
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

    def product(self, fr, fi, product_fn=None):
        """``product_step`` of the forward's blocks with this plan's
        spectrum, into the inverse's input dtype."""
        return product_step(self, fr, fi, self.hr, self.hi,
                            self.product_shift, self.product_width,
                            self.spectrum_width, self.inv.in_dtype,
                            product_fn)

    def edge_sides(self, payload: int, lead: int) -> tuple:
        """The convolution's edges of ``payload`` and ``lead`` that this
        chain can take (``LargeFFTPlan.takes_edge``): "window" where the
        forward's first pass can read the signal, "cut" where the inverse's
        last pass can write the output."""
        return tuple(side for side, plan in (("window", self.fwd),
                                             ("cut", self.inv))
                     if plan.takes_edge(side, payload, lead))

    def apply_blocks(self, xr, xi, pass_fn=None, product_fn=None,
                     window: Edges | None = None, cut: Edges | None = None):
        """[B, *fwd.block_in_shape] blocks in ``fwd.in_dtype`` -> the
        inverse's [B, *fwd.block_in_shape] blocks in ``inv.out_dtype``.  On
        the card the passes go out as the plans' prepared chains and the
        product as a ``PreparedProduct``; ``pass_fn`` and ``product_fn``
        run them one call each instead (``fused_pass``,
        ``spectrum_product``), and ``pass_fn=fused_pass_reference`` with
        ``product_fn=spectrum_product_reference`` the plain versions on any
        device.  With ``window`` the input is the convolution's signal [S,
        length], with ``cut`` the output its result [S, length]
        (``LargeFFTPlan.apply_blocks``; ``edge_sides`` says which the
        chain takes)."""
        fr, fi = self.fwd.apply_blocks(xr, xi, pass_fn=pass_fn,
                                       window=window)
        # where the caller handed temporaries (the convolution's blocks),
        # their memory is free again before P1 and the inverse allocate
        del xr, xi
        return self.inv.apply_blocks(*self.product(fr, fi, product_fn),
                                     pass_fn=pass_fn, cut=cut)

    def forward(self, x_re, x_im):
        """``apply_blocks`` on blocks of the forward's input shape and
        dtype, else ValueError."""
        want = (self.fwd.in_dtype, self.fwd.block_in_shape)
        for x in (x_re, x_im):
            if (x.dtype, tuple(x.shape[1:])) != want or x.dim() != 3:
                raise ValueError(f"expected [B, {want[1][0]}, {want[1][1]}] "
                                 f"{want[0]} blocks, got {x.dtype} "
                                 f"{tuple(x.shape)}")
        return self.apply_blocks(x_re, x_im)

    def capture(self):
        """``runtime.graph.captured(self)``: the whole chain replayed from
        one CUDA graph per input (shape, dtype, device).  Its outputs are
        static (see ``CapturedCall``); a ``retune`` of either plan and
        ``.to()`` drop its graphs."""
        from ..runtime.graph import captured

        return self._track(captured(self))
