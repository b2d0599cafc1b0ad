"""Channel-parallel batched FFT on one device.

Counterpart of ``intfftk_tpu/parallel/channelizer.py:25-141``, BASELINE
config 3: thousands of independent channels, each an n-point integer FFT.
The JAX class shards the channels over a mesh axis with ``shard_map``;
here they run on one device, one kernel launch per call.  Sharding the
channels over several cards waits for the ``torch.distributed`` slice
(ROADMAP Queue A, 'Distributed layer').
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import FFTConfig

from ..device import resolve
from ..ops.single_pass import PallasFFTPlan
from .four_step import local_plan, resolve_kernel


class Channelizer(nn.Module):
    """Batched integer FFT over channels on ``device`` (the current CUDA
    device unless the caller names one; ``device="cpu"`` for the CPU).

    ``layout="cn"``: int32 [channels, ..., n], the transform along the last
    axis (``FusedAxisFFT``: the kernel reads each tile turned);
    ``layout="nc"``: int32 [n, channels], the transform down the rows with
    the channels along the columns (``PallasFFTPlan(layout="nb")``).
    ``kernel``: "auto"/"pallas" run the CUDA kernel (its plain version on
    the CPU); "xla", the staged path, runs on the CPU only, in the "cn"
    layout only."""

    def __init__(self, cfg: FFTConfig, inverse: bool = False,
                 kernel: str = "auto", layout: str = "cn",
                 device: torch.device | str | None = None):
        super().__init__()
        if layout not in ("cn", "nc"):
            raise ValueError(f"bad layout {layout!r}")
        self.cfg, self.layout = cfg, layout
        self.device = resolve(device)
        self.kernel = resolve_kernel(kernel, self.device, cfg)
        if layout == "nc":
            if self.kernel != "pallas":
                raise NotImplementedError(
                    "layout='nc' needs the kernel (n <= 4096, output <= "
                    "32 bits)")
            self.plan = PallasFFTPlan(cfg, inverse=inverse, layout="nb",
                                      device=self.device)
        else:
            self.plan = local_plan(cfg, inverse, self.kernel, self.device)

    def shard(self, x) -> torch.Tensor:
        """A host array as int32 on this channelizer's device."""
        return torch.as_tensor(np.asarray(x)).to(device=self.device,
                                                 dtype=torch.int32)

    def stream(self, lane_tile: int = 128, depth: int = 2):
        """A ``runtime.StreamExecutor`` feeding this channelizer: bursty
        [n, c] chunks are repacked into [n, lane_tile] tiles and
        transformed in order, ``depth`` dispatches in flight.  For "nc"
        the tiles are the plan's own layout; for "cn" each tile is turned
        to [lane_tile, n] and back."""
        from ..runtime.stream import StreamExecutor

        if self.layout == "nc":
            tile_plan = self
        else:
            def tile_plan(xr, xi):
                yr, yi = self(xr.t(), xi.t())
                return yr.t(), yi.t()

        return StreamExecutor(tile_plan, self.cfg.n, lane_tile=lane_tile,
                              depth=depth, device=self.device)

    def forward(self, x_re, x_im):
        """int32 [channels, ..., n] ("cn") or [n, channels] ("nc") on this
        device -> int32 of the same shape."""
        yr, yi = self.plan(x_re, x_im)
        return yr.to(torch.int32), yi.to(torch.int32)
