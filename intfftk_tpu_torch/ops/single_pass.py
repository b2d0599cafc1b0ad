"""The single-pass engines for n <= 4096: one launch of the factor-pass
kernel per call.

Counterpart of ``intfftk_tpu/ops/pallas_fft.py``: ``PallasFFTPlan``
(:788-894, the kernel K4 ``PallasFFTPlan._kernel`` :829),
``FusedAxisFFT`` (:1432-1480, K2 ``_FusedPass._kernel`` with the
transposed load and store) and ``PallasWideFFTPlan`` (:716-785, K5
``PallasWideFFTPlan._kernel`` :742, data wider than 32 bits as four int32
planes there, int64 here).  On the card each is one launch of
``csrc/fused_pass.cu`` through ``fused_fft.fused_pass`` on a view of the
input: [1, n, B] for the ``[n, B]`` layout, [1, B, n] read and stored
turned for the ``[B, n]`` layout.  No torch transpose runs around the
kernel.  On the CPU the same call runs its plain version.

The JAX plan asks for a batch that is a multiple of the TPU's 128-lane
granule (``LANE_TILE``, :68).  Here any batch >= 1 is taken: the kernel's
tail CTA masks its loads and stores.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import FFTConfig

from ..device import resolve
from .fused_fft import MAX_ROWS, fused_pass
from .transform import check_width, pack_tables


def _check_single(cfg: FFTConfig, order: str, wide: bool):
    if cfg.n > MAX_ROWS:
        raise NotImplementedError(
            f"the single-pass kernel takes n <= {MAX_ROWS}; use "
            f"LargeFFTPlan for n = {cfg.n}")
    check_width(cfg)
    if not wide and cfg.output_width > 32:
        raise NotImplementedError(
            f"an output of {cfg.output_width} bits is wider than this "
            f"engine's 32: use PallasWideFFTPlan")
    if order not in ("natural", "bitrev"):
        raise ValueError(f"bad order {order!r}")


class FusedAxisFFT(nn.Module):
    """Transform along the last axis of [..., n] integers (n <= 4096,
    output <= 32 bits): int32 in, int32 out, one kernel launch per call.

    ``inverse``: the unnormalised inverse; ``order``: "natural" spectrum,
    or "bitrev", the raw core contract (the forward emits a bit-reversed
    spectrum, the inverse consumes one).  The packed stage tables are
    buffers ``w_re``/``w_im`` on ``device`` (the current CUDA device
    unless the caller names one; ``device="cpu"`` for the plain version)."""

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 order: str = "natural",
                 device: torch.device | str | None = None):
        super().__init__()
        _check_single(cfg, order, wide=False)
        self.cfg, self.inverse, self.order = cfg, inverse, order
        w_re, w_im = pack_tables(cfg)
        device = resolve(device)
        self.register_buffer("w_re", torch.as_tensor(w_re, device=device))
        self.register_buffer("w_im", torch.as_tensor(w_im, device=device))

    def _pass(self, x_re, x_im, turned: bool):
        """One ``fused_pass`` on int32 [1, n, B] blocks, or on [1, B, n]
        blocks read and stored turned."""
        return fused_pass(x_re, x_im, self.cfg, (self.w_re, self.w_im),
                          inverse=self.inverse,
                          natural=self.order == "natural",
                          transpose_in=turned, transpose_out=turned)

    def forward(self, x_re, x_im):
        """[..., n] integers -> int32 [..., n], on the input's device."""
        n = self.cfg.n
        if x_re.dim() < 1 or x_re.shape[-1] != n:
            raise ValueError(f"expected [..., n={n}], got "
                             f"{tuple(x_re.shape)}")
        shp = x_re.shape
        blk = lambda x: x.to(torch.int32).reshape(1, -1, n).contiguous()
        yr, yi = self._pass(blk(x_re), blk(x_im), turned=True)
        return yr.reshape(shp), yi.reshape(shp)


class PallasFFTPlan(FusedAxisFFT):
    """The single-pass transform of a 2-D tile, n <= 4096: layout "nb" is
    [n, B] (the transform down the rows, one transform per column), "bn"
    is [B, n].  Int32 in and out, one kernel launch per call, any B >= 1.
    ``inverse`` and ``order`` as ``FusedAxisFFT``."""

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 layout: str = "nb", order: str = "natural",
                 device: torch.device | str | None = None):
        super().__init__(cfg, inverse=inverse, order=order, device=device)
        if layout not in ("nb", "bn"):
            raise ValueError(f"bad layout {layout!r}")
        self.layout = layout

    def forward(self, x_re, x_im):
        n, shp = self.cfg.n, tuple(x_re.shape)
        axis = 1 if self.layout == "bn" else 0
        if len(shp) != 2 or shp[axis] != n:
            want = "[B, n={}]" if self.layout == "bn" else "[n={}, B]"
            raise ValueError(f"expected a {want.format(n)} tile, got {shp}")
        if self.layout == "bn":
            return super().forward(x_re, x_im)
        blk = lambda x: x.to(torch.int32).reshape(1, n, -1).contiguous()
        yr, yi = self._pass(blk(x_re), blk(x_im), turned=False)
        return yr.reshape(shp), yi.reshape(shp)


class PallasWideFFTPlan(nn.Module):
    """The single-pass transform of an [n, B] tile, n <= 4096, whose data
    path is wider than 32 bits (output <= 64): int64 in and out, one kernel
    launch per call on the [1, n, B] view, any B >= 1.  ``inverse`` and
    ``order`` ("natural" or "bitrev") as ``PallasFFTPlan``; the packed
    stage tables are buffers ``w_re``/``w_im`` on ``device``."""

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 order: str = "natural",
                 device: torch.device | str | None = None):
        super().__init__()
        _check_single(cfg, order, wide=True)
        self.cfg, self.inverse, self.order = cfg, inverse, order
        w_re, w_im = pack_tables(cfg)
        device = resolve(device)
        self.register_buffer("w_re", torch.as_tensor(w_re, device=device))
        self.register_buffer("w_im", torch.as_tensor(w_im, device=device))

    def forward(self, x_re, x_im):
        """[n, B] integers -> int64 [n, B], on the input's device."""
        n, shp = self.cfg.n, tuple(x_re.shape)
        if len(shp) != 2 or shp[0] != n:
            raise ValueError(f"expected a [n={n}, B] tile, got {shp}")
        blk = lambda x: x.to(torch.int64).reshape(1, n, -1).contiguous()
        yr, yi = fused_pass(blk(x_re), blk(x_im), self.cfg,
                            (self.w_re, self.w_im), inverse=self.inverse,
                            natural=self.order == "natural",
                            transpose_out=False)
        return yr.reshape(shp), yi.reshape(shp)
