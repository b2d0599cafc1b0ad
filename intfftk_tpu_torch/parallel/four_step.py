"""The four-step FFT sharded over a mesh axis, and the local-transform
engine of the parallel plans.

Counterpart of ``intfftk_tpu/parallel/four_step.py``: ``resolve_kernel``
and ``local_plan`` (:46-70), and ``FourStepPlan`` (:73-195), the
transform of n = n1 x n2 points whose [n1, n2] matrix is split over the D
ranks of one mesh axis, bit-identical to ``golden.four_step.four_step_int``.

Per rank, with B the local batch (the leading dimensions; with
``batch_axis`` they are split over that axis too):

1. turn 1: the input rows [B, n1/D, n2] become columns [B, n1, n2/D];
2. ``column_pass``: the n1-point column transforms times the inter-factor
   twiddle W_n^(+-k1*j2), one ``fused_pass`` with this rank's column slice
   of ``circle_table`` as its epilogue ([n1, n2/D], built once per plan),
   stored with the k1 rows outermost: [B, n1, n2/D];
3. turn 2: the columns become k1 rows [B, n1/D, n2];
4. ``row_pass``: the n2-point row transforms, one ``fused_pass`` reading
   the rows turned, stored as D[k1, k2] [B, n1/D, n2] (``natural_out=
   False``) or as [B, n2, n1/D], the order turn 3 sends;
5. turn 3 (``natural_out=True``): the natural spectrum X[k2*n1 + k1],
   sharded contiguously: [B, n2/D, n1].

A turn is ``corner_turn``: JAX's tiled ``all_to_all`` (split one
dimension into D chunks, chunk r to rank r, join what arrives along
another) as one ``dist.all_to_all_single`` per plane on the axis's group,
whose send buffer is chunk-major [D, ...].  Besides the collective a turn
copies twice at most, and not at all where the layout already is the one
wanted: the send buffer when the split dimension is not the outermost
(turn 1 for D > 1; turns 2 and 3 for D > 1 and B > 1), and the received
chunks when they do not join for free (turns 2 and 3 for D > 1; turn 1
for D > 1 and B > 1).  At D = 1 no turn copies.  The exchanged blocks are
int32, as the JAX plan's (NCCL has no 16-bit integer type).

On the card both passes are the kernel with the twiddle inside it; on the
CPU ``fused_pass`` runs its plain version, and ``kernel="xla"`` runs the
staged ``FFTPlan`` and ``cmult_exact`` instead (the CPU only).  A factor
above 4096 or an output above 32 bits raises ``NotImplementedError`` on
the card, as the JAX package sends them to its XLA path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..config import FFTConfig

from ..device import resolve, use_kernel
from ..ops.fused_fft import MAX_ROWS, circle_table, fused_pass
from ..ops.intmath import cmult_exact
from ..ops.single_pass import FusedAxisFFT
from ..ops.transform import FFTPlan
from .mesh import FFT_AXIS, gather, plan_device, shard, single_axis_size


def resolve_kernel(kernel: str, device: torch.device | str | None,
                   *cfgs: FFTConfig) -> str:
    """The local-transform engine: "pallas" (the single-pass CUDA kernel,
    the name kept from the JAX package), "xla" (the staged eager path), or
    "auto" (the kernel whenever every config fits it: n <= 4096, output
    <= 32 bits).  The staged path runs on the CPU only: on the card every
    transform goes through a kernel, so "xla" on a CUDA device raises."""
    device = resolve(device)
    if kernel == "auto":
        fits = all(c.n <= MAX_ROWS and c.output_width <= 32 for c in cfgs)
        kernel = "pallas" if fits else "xla"
    if kernel not in ("pallas", "xla"):
        raise ValueError(f"bad kernel {kernel!r}")
    if kernel == "xla" and use_kernel(device):
        raise NotImplementedError(
            "no engine on the card for this config: the local transform "
            "takes n <= 4096 and outputs of <= 32 bits; wider channels go "
            "to the staged path, as the JAX package routes them to its "
            "XLA one, and the staged path runs on the CPU only")
    return kernel


def local_plan(cfg: FFTConfig, inverse: bool, kernel: str,
               device: torch.device | str | None = None):
    """Local transform plan along the last axis: ``FusedAxisFFT`` for
    "pallas", the staged ``FFTPlan`` for "xla"; on the current CUDA device
    unless ``device`` names one."""
    device = resolve(device)
    if kernel == "pallas":
        return FusedAxisFFT(cfg, inverse=inverse, device=device)
    return FFTPlan(cfg, inverse=inverse, device=device)


def epilogue_slice(cfg: FFTConfig, n1: int, n2: int, inverse: bool,
                   rank: int, size: int):
    """Rank ``rank``'s column slice of ``circle_table(cfg, n1, n2,
    inverse)``: W_n^(+-k1*j2) for the global columns j2 of that rank, as
    contiguous int32 [n1, n2/size] arrays."""
    w = n2 // size
    er, ei = circle_table(cfg, n1, n2, inverse)
    cols = slice(rank * w, (rank + 1) * w)
    return (np.ascontiguousarray(er[:, cols]),
            np.ascontiguousarray(ei[:, cols]))


class FourStepPasses(nn.Module):
    """The rank-local half of a four-step plan for rank ``rank`` of
    ``size``, on ``device``: the two factor plans (``local_plan``:
    ``plan1`` over n1 and ``plan2`` over n2, forward or inverse) and the
    rank's epilogue slice ``er``/``ei``, built once."""

    def __init__(self, cfg: FFTConfig, n1: int, n2: int, inverse: bool = False,
                 natural_out: bool = True, kernel: str = "auto",
                 rank: int = 0, size: int = 1,
                 device: torch.device | str | None = None):
        super().__init__()
        if n1 * n2 != cfg.n:
            raise ValueError(f"n1*n2 = {n1 * n2} != cfg.n = {cfg.n}")
        for f in (n1, n2):
            if f < 8 or f & (f - 1):
                raise ValueError(f"factors must be powers of two >= 8, "
                                 f"got {n1}x{n2}")
        if n1 % size or n2 % size:
            raise ValueError(f"both factors must divide over {size} devices")
        device = resolve(device)
        self.cfg, self.n1, self.n2 = cfg, n1, n2
        self.inverse, self.natural_out = inverse, natural_out
        self.rank, self.size = rank, size
        self.cfg1 = dataclasses.replace(cfg, n=n1)
        self.cfg2 = dataclasses.replace(cfg, n=n2,
                                        data_width=self.cfg1.output_width)
        if self.cfg2.output_width > 32:
            raise NotImplementedError(
                f"an output of {self.cfg2.output_width} bits: the sharded "
                f"four-step exchanges int32 blocks, as the JAX plan does")
        self.kernel = resolve_kernel(kernel, device, self.cfg1, self.cfg2)
        self.plan1 = local_plan(self.cfg1, inverse, self.kernel, device)
        self.plan2 = local_plan(self.cfg2, inverse, self.kernel, device)
        er, ei = epilogue_slice(cfg, n1, n2, inverse, rank, size)
        self.register_buffer("er", torch.as_tensor(er, device=device))
        self.register_buffer("ei", torch.as_tensor(ei, device=device))


def _check_rank(x, plan, shape, rank: int, size: int, what: str):
    if (rank, size) != (plan.rank, plan.size):
        raise ValueError(f"{what} of rank {rank} of {size} given the passes "
                         f"of rank {plan.rank} of {plan.size}")
    if x.dim() != 3 or tuple(x.shape[1:]) != shape:
        raise ValueError(f"{what} takes [B, {shape[0]}, {shape[1]}] blocks, "
                         f"got {tuple(x.shape)}")


def column_pass(x_re, x_im, plan, rank: int, size: int, pass_fn=fused_pass):
    """The column transforms of rank ``rank`` of ``size``: int32 [B, n1,
    n2/size] (all rows, this rank's columns) -> int32 [B, n1, n2/size], the
    n1-point transform down each column times W_n^(+-k1*j2), k1 rows
    outermost.  ``plan``: a ``FourStepPlan``, or the ``FourStepPasses``
    of that rank.
    One ``fused_pass`` with the epilogue slice (the kernel on the card;
    ``pass_fn=fused_pass_reference``: the plain version on any device);
    with ``kernel="xla"`` the staged plan and ``cmult_exact``."""
    plan = getattr(plan, "passes", plan)
    _check_rank(x_re, plan, (plan.n1, plan.n2 // size), rank, size,
                "column_pass")
    er, ei, p, cfg = plan.er, plan.ei, plan.plan1, plan.cfg1
    if plan.kernel == "pallas":
        return pass_fn(x_re, x_im, cfg, (p.w_re, p.w_im), epi=(er, ei),
                       inverse=plan.inverse, transpose_out=False)
    br, bi = p(x_re.transpose(1, 2), x_im.transpose(1, 2))   # [B, C, n1]
    cr, ci = cmult_exact(br, bi, er.t(), ei.t(), cfg.twiddle_shift,
                         cfg.output_width, twiddle_width=cfg.twiddle_width)
    return tuple(c.transpose(1, 2).to(torch.int32).contiguous()
                 for c in (cr, ci))


def row_pass(x_re, x_im, plan, rank: int, size: int, pass_fn=fused_pass):
    """The row transforms of rank ``rank`` of ``size``: int32 [B, n1/size,
    n2] (this rank's k1 rows) -> the n2-point transform along each row,
    int32 [B, n1/size, n2] (D[k1, k2]) with ``natural_out=False``, else
    [B, n2, n1/size] (k2 rows: the order turn 3 sends).  One ``fused_pass``
    reading the rows turned (``pass_fn`` as ``column_pass``); with
    ``kernel="xla"`` the staged plan."""
    plan = getattr(plan, "passes", plan)
    _check_rank(x_re, plan, (plan.n1 // size, plan.n2), rank, size,
                "row_pass")
    p = plan.plan2
    if plan.kernel == "pallas":
        return pass_fn(x_re, x_im, plan.cfg2, (p.w_re, p.w_im),
                       inverse=plan.inverse, transpose_in=True,
                       transpose_out=not plan.natural_out)
    yr, yi = p(x_re, x_im)
    if plan.natural_out:
        yr, yi = yr.transpose(1, 2), yi.transpose(1, 2)
    return yr.to(torch.int32).contiguous(), yi.to(torch.int32).contiguous()


def send_buffer(x: torch.Tensor, split: int, size: int) -> torch.Tensor:
    """The chunk-major send buffer of a turn: dimension ``split`` of ``x``
    cut into ``size`` chunks, the chunk index made outermost: [size, ...]
    (a copy unless the move is trivial)."""
    k = x.shape[split] // size
    return x.unflatten(split, (size, k)).movedim(split, 0).contiguous()


def join_received(y: torch.Tensor, concat: int) -> torch.Tensor:
    """The chunks a turn received, [size (source rank), ...], joined along
    dimension ``concat`` of one chunk in rank order (a copy unless they
    join for free)."""
    return y.movedim(0, concat).flatten(concat, concat + 1).contiguous()


def corner_turn(x: torch.Tensor, split: int, concat: int, group,
                size: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all(split_axis=split, concat_axis=concat)`` on
    one plane: ``dist.all_to_all_single`` on ``group`` between
    ``send_buffer`` and ``join_received``."""
    send = send_buffer(x, split, size)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return join_received(recv, concat)


class FourStepPlan(nn.Module):
    """Mesh-sharded four-step integer FFT of size n = n1 * n2 (SPMD: every
    rank of the mesh builds it and calls it with its own shard).

    ``axis``: the mesh axis the transform is split over (D ranks; both
    factors must divide by D).  ``natural_out``: the natural-order spectrum
    (3 turns), or the frequency matrix D[k1, k2] row-sharded (2 turns).
    ``batch_axis``: the leading batch dimension is split over that axis
    too (``shard``/``gather`` slice and join it).  ``kernel``: see
    ``resolve_kernel``.  ``device``: the mesh's device unless named (the
    card, or the CPU on a CPU mesh)."""

    def __init__(self, cfg: FFTConfig, n1: int, n2: int, mesh: DeviceMesh,
                 axis: str = FFT_AXIS, inverse: bool = False,
                 natural_out: bool = True, batch_axis: str | None = None,
                 kernel: str = "auto",
                 device: torch.device | str | None = None):
        super().__init__()
        d = single_axis_size(mesh, axis)
        self.mesh, self.axis, self.batch_axis = mesh, axis, batch_axis
        self.rank, self.size = mesh.get_local_rank(axis), d
        self.group = mesh.get_group(axis)
        self.passes = FourStepPasses(cfg, n1, n2, inverse, natural_out,
                                     kernel, self.rank, d,
                                     plan_device(mesh, device))
        self.cfg, self.n1, self.n2 = cfg, n1, n2
        self.inverse, self.natural_out = inverse, natural_out
        self.kernel = self.passes.kernel
        self.out_width = self.passes.cfg2.output_width

    def turn(self, x: torch.Tensor, split: int, concat: int) -> torch.Tensor:
        """One corner turn of one plane over this plan's axis."""
        return corner_turn(x, split, concat, self.group, self.size)

    def forward(self, x_re, x_im, pass_fn=fused_pass):
        """This rank's shard, integers [..., n/D] (natural order, the
        contiguous slice r*n/D ... of each transform) -> int32 [..., n/D]
        (natural) or [..., n1/D, n2] (D[k1, k2], rows r*n1/D ...), on the
        plan's device.  ``pass_fn=fused_pass_reference`` runs the plain
        version of both passes on any device."""
        n, n1, n2, d, r = self.cfg.n, self.n1, self.n2, self.size, self.rank
        dev = self.passes.er.device
        xr = torch.as_tensor(x_re).to(device=dev, dtype=torch.int32)
        xi = torch.as_tensor(x_im).to(device=dev, dtype=torch.int32)
        if xr.dim() < 1 or xr.shape[-1] != n // d:
            raise ValueError(f"expected this rank's [..., n/D = {n // d}], "
                             f"got {tuple(xr.shape)}")
        shp = xr.shape[:-1]
        b = math.prod(shp)
        rows = lambda x: x.reshape(b, n1 // d, n2)
        ar, ai = (self.turn(rows(x), 2, 1) for x in (xr, xi))
        cr, ci = column_pass(ar, ai, self.passes, r, d, pass_fn)
        br, bi = (self.turn(x, 1, 2) for x in (cr, ci))
        yr, yi = row_pass(br, bi, self.passes, r, d, pass_fn)
        if self.natural_out:
            yr, yi = (self.turn(x, 1, 2) for x in (yr, yi))
        out = (n // d,) if self.natural_out else (n1 // d, n2)
        return yr.reshape(shp + out), yi.reshape(shp + out)

    def shard(self, x) -> torch.Tensor:
        """This rank's shard of a global host array [..., n]: the
        contiguous slice of the last dimension over ``axis`` and, with
        ``batch_axis``, of the leading dimension over that axis."""
        t = shard(x, self.mesh, self.axis, -1)
        if self.batch_axis is not None:
            t = shard(t, self.mesh, self.batch_axis, 0)
        return t

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The global result from every rank's output shard (an all-gather
        over ``axis``, and over ``batch_axis`` when it is set)."""
        y = gather(y, self.mesh, self.axis, -1 if self.natural_out else -2)
        if self.batch_axis is not None:
            y = gather(y, self.mesh, self.batch_axis, 0)
        return y
