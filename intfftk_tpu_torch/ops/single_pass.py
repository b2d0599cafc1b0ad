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

Each plan resolves the device's tuning row at build and records it as
``plan.tuning`` (``pallas_fft.py:735, :819``); ``lane_tile=`` overrides the
row's TC (``wide_lane_tile`` on the int64 tile of ``PallasWideFFTPlan``),
and ``plan.geometry`` is what its pass launches with (``lane_tile``,
``threads``: ``tuning.pass_geometry``, with the batch unknown until the
call; ``retune``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import FFTConfig

from ..device import resolve, use_kernel
from .fused_fft import PreparedChain, PreparedPlan, fused_pass
from .transform import check_width, pack_tables
from .tuning import KernelTuning, device_tuning, pass_geometry


def _check_single(cfg: FFTConfig, order: str, wide: bool,
                  tuning: KernelTuning):
    if cfg.n > tuning.max_rows:
        raise NotImplementedError(
            f"the single-pass kernel takes n <= {tuning.max_rows}; use "
            f"LargeFFTPlan for n = {cfg.n}")
    check_width(cfg)
    if not wide and cfg.output_width > 32:
        raise NotImplementedError(
            f"an output of {cfg.output_width} bits is wider than this "
            f"engine's 32: use PallasWideFFTPlan")
    if order not in ("natural", "bitrev"):
        raise ValueError(f"bad order {order!r}")


class _SinglePass(PreparedPlan):
    """What the single-pass engines share: the tuning row, the launch
    geometry of their one pass, the packed stage tables, and the launch:
    on a CUDA tensor through a chain of the one pass prepared for that
    shape, on a CPU tensor through ``fused_pass``'s plain version."""

    wide = False

    def _setup(self, cfg: FFTConfig, inverse: bool, order: str, device,
               lane_tile: int | None):
        device = resolve(device)
        self.cfg, self.inverse, self.order = cfg, inverse, order
        self.lane_tile = lane_tile
        self.retune(device_tuning(device))
        _check_single(cfg, order, self.wide, self.tuning)
        w_re, w_im = pack_tables(cfg)
        self.register_buffer("w_re", torch.as_tensor(w_re, device=device))
        self.register_buffer("w_im", torch.as_tensor(w_im, device=device))

    def retune(self, tuning: KernelTuning):
        """Record ``tuning`` as ``self.tuning`` and the launch geometry it
        gives the pass as ``geometry`` (the ``lane_tile`` override kept).
        The build calls it with the device's row;
        ``tools/sweep_tuning.py`` with the rows it times.  The prepared
        chains and the captured graphs of the old geometry are dropped."""
        self.invalidate()
        self.tuning = tuning
        self.geometry = pass_geometry(tuning, self.cfg.n, None, self.wide,
                                      self.lane_tile)

    def _pass(self, x_re, x_im, turned: bool = False):
        """The one pass on [1, n, B] blocks, or on [1, B, n] blocks read and
        stored turned, in the plan's block dtype (int64 on the wide
        plan)."""
        kw = lambda: dict(tables=(self.w_re, self.w_im), inverse=self.inverse,
                          natural=self.order == "natural",
                          transpose_in=turned, transpose_out=turned,
                          **self.geometry)
        if use_kernel(x_re.device):
            key = (x_re.shape, x_re.dtype, x_re.device, turned)
            return self._prepare(key, lambda: PreparedChain(
                *key[:3], [(self.cfg, kw())]))(x_re, x_im)
        return fused_pass(x_re, x_im, self.cfg, **kw())

    def capture(self):
        """``runtime.graph.captured(self)``: this plan's call replayed from
        one CUDA graph per input (shape, dtype, device), the port's
        counterpart of the JAX plan's ``jax.jit``.  Its outputs are static:
        each call overwrites the previous call's outputs of the same key
        (see ``CapturedCall``).  ``retune`` and ``.to()`` drop its
        graphs."""
        from ..runtime.graph import captured

        return self._track(captured(self))


class FusedAxisFFT(_SinglePass):
    """Transform along the last axis of [..., n] integers (n <= 4096,
    output <= 32 bits): int32 in, int32 out, one kernel launch per call.

    ``inverse``: the unnormalised inverse; ``order``: "natural" spectrum,
    or "bitrev", the raw core contract (the forward emits a bit-reversed
    spectrum, the inverse consumes one).  The packed stage tables are
    buffers ``w_re``/``w_im`` on ``device`` (the current CUDA device
    unless the caller names one; ``device="cpu"`` for the plain version).
    ``lane_tile``: TC, overriding the device row's ``lane_tile``."""

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 order: str = "natural",
                 device: torch.device | str | None = None,
                 lane_tile: int | None = None):
        super().__init__()
        self._setup(cfg, inverse, order, device, lane_tile)

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
    ``inverse``, ``order`` and ``lane_tile`` as ``FusedAxisFFT``."""

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 layout: str = "nb", order: str = "natural",
                 device: torch.device | str | None = None,
                 lane_tile: int | None = None):
        super().__init__(cfg, inverse=inverse, order=order, device=device,
                         lane_tile=lane_tile)
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


class PallasWideFFTPlan(_SinglePass):
    """The single-pass transform of an [n, B] tile, n <= 4096, whose data
    path is wider than 32 bits (output <= 64): int64 in and out, one kernel
    launch per call on the [1, n, B] view, any B >= 1.  ``inverse`` and
    ``order`` ("natural" or "bitrev") as ``PallasFFTPlan``; the packed
    stage tables are buffers ``w_re``/``w_im`` on ``device``.
    ``lane_tile``: TC on the int64 tile, overriding the device row's
    ``wide_lane_tile``."""

    wide = True

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 order: str = "natural",
                 device: torch.device | str | None = None,
                 lane_tile: int | None = None):
        super().__init__()
        self._setup(cfg, inverse, order, device, lane_tile)

    def forward(self, x_re, x_im):
        """[n, B] integers -> int64 [n, B], on the input's device."""
        n, shp = self.cfg.n, tuple(x_re.shape)
        if len(shp) != 2 or shp[0] != n:
            raise ValueError(f"expected a [n={n}, B] tile, got {shp}")
        blk = lambda x: x.to(torch.int64).reshape(1, n, -1).contiguous()
        yr, yi = self._pass(blk(x_re), blk(x_im))
        return yr.reshape(shp), yi.reshape(shp)
