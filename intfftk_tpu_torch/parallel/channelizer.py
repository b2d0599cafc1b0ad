"""Channel-parallel batched FFT.

Counterpart of ``intfftk_tpu/parallel/channelizer.py:25-141``, BASELINE
config 3: thousands of independent channels, each an n-point integer FFT,
one kernel launch per call.  With a ``mesh`` the channels are split over
its ``axis`` (SPMD: each rank holds and transforms its own channels), with
no communication at all; ``shard`` gives a rank its slice.  On the card a
call is replayed from a CUDA graph through ``capture()``, as the plans'.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import FFTConfig

from ..ops.fused_fft import PreparedPlan
from ..ops.single_pass import PallasFFTPlan
from ..runtime import trace
from .four_step import local_plan, resolve_kernel
from .mesh import CHANNEL_AXIS, plan_device, shard, single_axis_size


class Channelizer(PreparedPlan):
    """Batched integer FFT over channels on ``device`` (the current CUDA
    device unless the caller names one; ``device="cpu"`` for the CPU).

    ``layout="cn"``: int32 [channels, ..., n], the transform along the last
    axis (``FusedAxisFFT``: the kernel reads each tile turned);
    ``layout="nc"``: int32 [n, channels], the transform down the rows with
    the channels along the columns (``PallasFFTPlan(layout="nb")``).
    ``kernel``: "auto"/"pallas" run the CUDA kernel (its plain version on
    the CPU); "xla", the staged path, runs on the CPU only, in the "cn"
    layout only.  ``mesh``/``axis``: the channels (the leading dimension
    for "cn", the last for "nc") are split over that mesh axis; the device
    is then the mesh's unless named.  The positional order is the JAX
    class's (``intfftk_tpu/parallel/channelizer.py:37-39``), ``device`` in
    the slot of its ``interpret``: ``Channelizer(cfg, mesh)`` is the
    sharded forward channelizer.  The constructor is a ``plan.build`` span
    noting the layout and the engine ("cn FusedAxisFFT", "nc
    PallasFFTPlan(nb)")."""

    @trace.spanned("plan.build")
    def __init__(self, cfg: FFTConfig, mesh: DeviceMesh | None = None,
                 axis: str = CHANNEL_AXIS, inverse: bool = False,
                 kernel: str = "auto",
                 device: torch.device | str | None = None,
                 layout: str = "cn"):
        super().__init__()
        if layout not in ("cn", "nc"):
            raise ValueError(f"bad layout {layout!r}")
        self.cfg, self.layout = cfg, layout
        self.mesh, self.axis = mesh, axis
        self.device = plan_device(mesh, device)
        self.kernel = resolve_kernel(kernel, self.device, cfg)
        if layout == "nc":
            if self.kernel != "pallas":
                raise NotImplementedError(
                    "layout='nc' needs the kernel (n <= 4096, output <= "
                    "32 bits)")
            self.plan = PallasFFTPlan(cfg, inverse=inverse, layout="nb",
                                      device=self.device)
            trace.note("nc PallasFFTPlan(nb)")
        else:
            self.plan = local_plan(cfg, inverse, self.kernel, self.device)
            trace.note(f"cn {type(self.plan).__name__}")

    def shard(self, x) -> torch.Tensor:
        """A host array as int32 on this channelizer's device: with a mesh,
        this rank's contiguous slice of the channels."""
        if self.mesh is None:
            x = torch.as_tensor(np.asarray(x))
        else:
            x = shard(x, self.mesh, self.axis,
                      0 if self.layout == "cn" else -1)
        return x.to(device=self.device, dtype=torch.int32)

    def stream(self, lane_tile: int = 128, depth: int = 2):
        """A ``runtime.StreamExecutor`` feeding this channelizer: bursty
        [n, c] chunks are repacked into [n, lane_tile] tiles and
        transformed in order, ``depth`` dispatches in flight.  For "nc"
        the tiles are the plan's own layout; for "cn" each tile is turned
        to [lane_tile, n] and back.  With a mesh, ``lane_tile`` channels are
        one dispatch over the axis: it must divide over the axis's D ranks,
        and each rank's executor takes tiles of lane_tile / D of its own
        channels."""
        from ..runtime.stream import StreamExecutor

        if self.mesh is not None:
            d = single_axis_size(self.mesh, self.axis)
            if lane_tile % d:
                raise ValueError(f"lane_tile {lane_tile} must divide over "
                                 f"{d} devices on axis {self.axis!r}")
            lane_tile //= d
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

    def capture(self):
        """``runtime.graph.captured(self)``: the whole call (the shape check,
        the one pass, the casts) replayed from one CUDA graph per input
        (shape, dtype, device), the port's counterpart of the JAX class's
        ``jax.jit``.  It takes CUDA tensors only (a CPU tensor raises
        ValueError), with or without a ``mesh``: the channels exchange
        nothing.  Its outputs are static: each call overwrites the previous
        call's outputs of the same key (see ``CapturedCall``).  A
        ``retune`` of the plan and ``.to()`` drop its graphs."""
        from ..runtime.graph import captured

        return self._track(captured(self))
