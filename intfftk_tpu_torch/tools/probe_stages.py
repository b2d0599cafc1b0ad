"""Per-stage probe of the factor pass: what one radix-2 stage costs on the
card, by twiddle order, beside its arithmetic alone and its data movement
alone.

Counterpart of ``tools/probe_stages.py`` (the TPU's per-stage probe).  Its
two Pallas kernels are the hand-written CUDA kernels of
``csrc/probe_stages.cu``:

* ``_loop_kernel`` (:55) -> ``stage_loop(step, xr, xi, k, cfg, ...)``: a
  step applied ``k`` times to an ``[n, B]`` tile pair that stays in shared
  memory (in registers for the arithmetic steps);
* ``_once_kernel`` (:87) -> ``stage_once(step, xr, xi, cfg, ...)``: the step
  applied once, to hold a variant against the production stage bit for bit
  on the card before its time is believed.

The steps (``STEPS``): ``prod_p{0,1,2,3,4,5,7}``, the stage body the factor
pass runs (``csrc/stage_body.cuh``, one function for both) at a fixed
twiddle order; ``shfl_p{0..4}``, the same stage with a warp laid along the
rows and the partner row exchanged by a warp shuffle (the image of the TPU
tool's roll variant); ``arith6`` and ``arith12``, the TPU tool's op images
on registers; ``smem_roundtrip``, the stage's shared-memory loads, stores
and barrier with no arithmetic; ``epilogue_cmult``, the inter-factor
product against an ``[n, TC]`` table; on the int64 tile of the wide path
``prod64_p{0,1,7}``, ``smem64_roundtrip``, ``epilogue64_cmult``; and two
questions of a redesign: ``prodmode_p{0,7}``, the production stage with
its scale and rounding mode fixed at compile time; and ``twsmem_p7``, the
production stage with its twiddles staged in shared memory.  And the
answer: ``group{R}_p{P}``, the stage group the factor pass now runs
(``stage_group`` of ``csrc/stage_body.cuh``, again one function for both):
the R stages of the orders P ... P - R + 1 on 2^R rows held in registers,
through one exchange of the tile (``group3_p7``, ``group3_p4``: every stage
multiplies; ``group3_p3``: down to order 1; ``group3_p2``, ``group2_p1``,
``group1_p0``: the tails down to order 0; ``group2_p7``: two stages a
group); ``groupmode3_p7`` and
``groupmode2_p1`` with the mode fixed at compile time; and on the int64
tile ``group64_3_p7``, ``group64_2_p7`` (the same orders at R = 3 and
R = 2), ``group64_3_p2``, ``group64_2_p1``.  The ``prod_p*`` steps are the
yardstick a group is read against; every rate is per sample and *stage*
(an application of a group step counts its R stages).

Beside each kernel stands its plain PyTorch version
(``stage_loop_reference``: the eager stage ``ops.transform.dif_stage`` on
the row pairing of the tile, ``k`` times): a CPU tensor takes it, a CUDA
tensor launches the kernel and adds one to ``stage_loop.launches``.

Which data a comparison uses.  In scaled mode ``k`` applications halve the
data to zero within about 16, so a comparison at a large ``k`` would hold
zeros against zeros.  Every comparison (``bit_checks``, the tests) therefore
uses ``k`` <= 8, on two configs.  ``check_config``: unscaled, 16-bit data,
so that 8 stages fit the int32 tile (24 bits) and every bit compared is
live.  And ``probe_config`` (scaled/round, 16-bit data and twiddles, the
headline's numerics), the config of the timed run, so that the very
kernels that are timed (the scaled/round arm of every stage, and of a
fixed-mode step the kernel compiled for that mode) are the ones compared:
full-scale 16-bit data keep about 8 live bits after 8 halvings.  The timed
run then uses ``probe_config`` at any ``k``: integer timing on the card
does not depend on the data.

The measurement (``stage_rate``) is ``probe_vpu``'s discipline unchanged:
three loop lengths scaled from a pilot launch until the longest launch
takes ``TARGET_MS``, the three timed in turn over several rounds, the rate
from the difference of the longest and the shortest, so load, store and
launch cancel.  Two guards, both fatal (``GuardError``), nothing retaken:
the two half-ranges agree within ``LINEAR_TOL``; and no production step
runs faster than ``ARITH12_OPS`` lane-instructions per sample at
``lane_rate_peak``: a reading below that is a folded loop, not a fast
stage.  ``tools.audit_sass`` prints each loop's instruction count beside
its time, so a folded step is seen.

Usage, on a machine with the card:

    python -m intfftk_tpu_torch.tools.probe_stages [--quick] [--tall]

prints one JSON dict ``{step: ns_per_sample_per_stage}`` with the keys of
the TPU tool where a step means the same; every variant is checked against
its ``prod_p*`` first and a mismatch raises.  ``--tall``: ``TALL_STEPS`` on
the ``[4096, 4]`` tile of the channelizer's passes instead of every step on
``[256, 16]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import sys
from typing import NamedTuple

import torch

from ..config import FFTConfig
from ..device import use_kernel
from ..ops import _build
from ..ops.intmath import cmult_exact
from ..ops.transform import dif_stage, dit_stage, pack_tables
from . import probe_vpu
from .audit_sass import GROUP_SIZE, group_split
from .probe_vpu import GuardError, LINEAR_TOL


class Step(NamedTuple):
    """One step: its index in ``csrc/probe_stages.cu``, its twiddle order
    (0 where it has none; a group's top order), whether it runs on the
    int64 tile, whether it keeps its samples in registers, the production
    step a variant is held against ("" for none), and the stages one
    application runs (a group's R)."""
    index: int
    order: int
    wide: bool = False
    in_registers: bool = False
    variant_of: str = ""
    stages: int = 1


#: The step indices of ``csrc/probe_stages.cu``.  ``PROD_MODE`` stands for
#: the two fixed-mode kernels: ``kernel_index`` picks by the config.
(PROD, SHFL, ARITH6, ARITH12, SMEM, EPI, PROD_UNSCALED, PROD_ROUND,
 TW_SMEM, GROUP1, GROUP2, GROUP3, GROUP_UNSCALED2, GROUP_UNSCALED3,
 GROUP_ROUND2, GROUP_ROUND3) = range(16)
PROD_MODE = -1
#: The two fixed-mode kernels of a group step, by its R and the config.
GROUP_MODE = -2
#: The group steps' indices: ``GROUP1 + R - 1`` runs R stages.
GROUPS = (GROUP1, GROUP2, GROUP3, GROUP_MODE)
#: The steps that read the packed stage tables.
READS_TABLES = (PROD, SHFL, PROD_MODE, TW_SMEM) + GROUPS
PROD_ORDERS = (0, 1, 2, 3, 4, 5, 7)
SHFL_ORDERS = (0, 1, 2, 3, 4)
STEPS = {
    **{f"prod_p{p}": Step(PROD, p) for p in PROD_ORDERS},
    **{f"shfl_p{p}": Step(SHFL, p, variant_of=f"prod_p{p}")
       for p in SHFL_ORDERS},
    "arith6": Step(ARITH6, 0, in_registers=True),
    "arith12": Step(ARITH12, 0, in_registers=True),
    "smem_roundtrip": Step(SMEM, 7),
    "epilogue_cmult": Step(EPI, 0),
    **{f"prod64_p{p}": Step(PROD, p, wide=True) for p in (0, 1, 7)},
    "smem64_roundtrip": Step(SMEM, 7, wide=True),
    "epilogue64_cmult": Step(EPI, 0, wide=True),
    **{f"prodmode_p{p}": Step(PROD_MODE, p, variant_of=f"prod_p{p}")
       for p in (0, 7)},
    "twsmem_p7": Step(TW_SMEM, 7, variant_of="prod_p7"),
    **{f"group3_p{p}": Step(GROUP3, p, stages=3) for p in (7, 4, 3, 2)},
    "group2_p7": Step(GROUP2, 7, stages=2),
    "group2_p1": Step(GROUP2, 1, stages=2),
    "group1_p0": Step(GROUP1, 0),
    "groupmode3_p7": Step(GROUP_MODE, 7, variant_of="group3_p7", stages=3),
    "groupmode2_p1": Step(GROUP_MODE, 1, variant_of="group2_p1", stages=2),
    "group64_3_p7": Step(GROUP3, 7, wide=True, stages=3),
    "group64_2_p7": Step(GROUP2, 7, wide=True, stages=2),
    "group64_3_p2": Step(GROUP3, 2, wide=True, stages=3),
    "group64_2_p1": Step(GROUP2, 1, wide=True, stages=2),
}
#: The tallest tile of the pass, ``[4096, 4]`` with rows padded to 5 words
#: (one CTA per SM), and the steps timed on it (``--tall``): the group's
#: strided rows meet two-way bank conflicts there that the 17-word rows of
#: the ``[256, 16]`` tile do not have.
TALL_ROWS = 4096
TALL_STEPS = ("smem_roundtrip", "prod_p7", "group3_p7", "group3_p4",
              "group3_p2")
#: Source-level ops per sample of ``arith12``, the op image of a
#: multiplying stage: no production step runs in fewer lane-instructions.
ARITH12_OPS = 12
#: Loop lengths of a timed reading before they are scaled to the target.
K_BASE = (1024, 2560, 4096)
#: The most applications a comparison runs (see the module docstring).
MAX_CHECK_K = 8


def kernel_index(step: str, cfg: FFTConfig) -> int:
    """The index of a step's kernel in ``csrc/probe_stages.cu``; a
    fixed-mode step has one kernel per mode it was compiled for."""
    s = STEPS[step]
    if s.index not in (PROD_MODE, GROUP_MODE):
        return s.index
    if cfg.scale and cfg.rounding != "round":
        raise ValueError(f"step {step} is compiled for the unscaled and the "
                         f"scaled/round mode, not for scaled/truncate")
    if s.index == PROD_MODE:
        return PROD_ROUND if cfg.scale else PROD_UNSCALED
    return (GROUP_ROUND2 if cfg.scale else GROUP_UNSCALED2) + s.stages - 2


def probe_config(n: int = 256) -> FFTConfig:
    """The timed run's numerics: scaled/round, 16-bit data and twiddles."""
    return FFTConfig(n=n, mode="scaled", rounding="round", data_width=16,
                     twiddle_width=16)


def check_config(n: int = 256) -> FFTConfig:
    """The numerics of a comparison beside ``probe_config``: unscaled 16-bit
    data, so that ``MAX_CHECK_K`` stages fit the int32 tile and no bit
    compared is dead."""
    return FFTConfig(n=n, mode="unscaled", data_width=16, twiddle_width=16)


def _check_step(step: str, xr, xi, k: int, cfg: FFTConfig):
    if step not in STEPS:
        raise ValueError(f"bad step {step!r}, one of {tuple(STEPS)}")
    s = STEPS[step]
    want = torch.int64 if s.wide else torch.int32
    if (xr.dtype != want or xi.dtype != want or xr.dim() != 2
            or xr.shape != xi.shape or xr.shape[0] != cfg.n):
        raise ValueError(f"step {step} takes a pair of {want} [n={cfg.n}, B] "
                         f"tiles, got {xr.dtype} {tuple(xr.shape)}")
    if k < 0:
        raise ValueError(f"{k} applications < 0")
    kernel_index(step, cfg)
    if s.order >= max(cfg.stages, 1) or (s.index == SHFL and cfg.n < 32):
        raise ValueError(f"step {step} needs a tile of more than "
                         f"{max(1 << s.order, 16)} rows, got {cfg.n}")
    if s.order < s.stages - 1:
        raise ValueError(f"step {step}: {s.stages} stages from order "
                         f"{s.order} down")
    bits = 64 if s.wide else 32
    if cfg.data_width + k * s.stages * (1 - cfg.scale) > bits:
        raise ValueError(f"{k * s.stages} unscaled stages of "
                         f"{cfg.data_width}-bit data outgrow the {bits}-bit "
                         f"tile")


def stage_tables(cfg: FFTConfig, device):
    """The packed stage tables (w_re, w_im), int32 [n], on ``device``."""
    return tuple(torch.as_tensor(t, device=device) for t in pack_tables(cfg))


def epilogue_table(cfg: FFTConfig, tc: int, device):
    """An ``[n, tc]`` inter-factor table (er, ei), int32: W_(n*tc)^(k*c)."""
    from ..ops.fused_fft import circle_table

    big = dataclasses.replace(cfg, n=cfg.n * tc)
    return tuple(torch.as_tensor(t, device=device)
                 for t in circle_table(big, cfg.n, tc))


def _dif_rows(xr, xi, cfg, in_w, p, w_re, w_im):
    """One forward stage of order p on an int64 [n, B] tile: rows pair as
    (block, half, k), the pairing of ``_dif_stage_rows``."""
    b, h = xr.shape[1], 1 << p
    vr, vi = xr.t().reshape(b, -1, 2, h), xi.t().reshape(b, -1, 2, h)
    sr, si, yr, yi = dif_stage(vr[..., 0, :], vi[..., 0, :], vr[..., 1, :],
                               vi[..., 1, :], cfg, in_w, p, w_re[h: 2 * h],
                               w_im[h: 2 * h])
    return (torch.stack([sr, yr], dim=-2).reshape(b, -1).t(),
            torch.stack([si, yi], dim=-2).reshape(b, -1).t())


def _dit_rows(xr, xi, cfg, in_w, p, w_re, w_im):
    """One inverse stage of order p on an int64 [n, B] tile: B times the
    conjugate twiddle first (the pairing of ``_dit_stage_rows``)."""
    b, h = xr.shape[1], 1 << p
    vr, vi = xr.t().reshape(b, -1, 2, h), xi.t().reshape(b, -1, 2, h)
    ar, ai, br, bi = dit_stage(vr[..., 0, :], vi[..., 0, :], vr[..., 1, :],
                               vi[..., 1, :], cfg, in_w, p, w_re[h: 2 * h],
                               w_im[h: 2 * h])
    return (torch.stack([ar, br], dim=-2).reshape(b, -1).t(),
            torch.stack([ai, bi], dim=-2).reshape(b, -1).t())


def group_reference(xr, xi, cfg: FFTConfig, top: int, stages: int, in_w: int,
                    tables, inverse: bool = False):
    """Plain version of one stage group (``stage_group`` of
    ``csrc/stage_body.cuh``) on an int64 [n, B] tile: the ``stages`` stages
    of the twiddle orders ``top`` ... ``top - stages + 1``, forward from the
    top order down, inverse from the bottom order up, one after the other
    with the radix-2 numerics of ``ops.transform``.  ``in_w``: the width
    entering the group's first stage; each stage adds ``1 - cfg.scale``."""
    orders = range(top, top - stages, -1)
    for j, q in enumerate(reversed(orders) if inverse else orders):
        stage = _dit_rows if inverse else _dif_rows
        xr, xi = stage(xr, xi, cfg, in_w + j * (1 - cfg.scale), q, *tables)
    return xr, xi


def library_group_split(log_rows: int, wide: bool = False):
    """``group_split`` as the built library's host code computes it."""
    lib = _build.library()
    tops, sizes = (ctypes.c_int * 12)(), (ctypes.c_int * 12)()
    n = lib.intfft_group_split(log_rows, int(wide), tops, sizes)
    return [(tops[g], sizes[g]) for g in range(n)]


def _arith(index, xr, xi):
    """The TPU tool's op images (``tools/probe_stages.py:224-234``) in the
    tile's wrapping int32 arithmetic."""
    sr = (xr + xi + 1) >> 1
    si = (xr - xi + 1) >> 1
    if index == ARITH6:
        return sr, si
    pr = (sr * 23170 - si * 12540) >> 15
    pi = ((si * 23170 + sr * 12540) >> 15) + 1
    return (pr << 16) >> 16, (pi << 16) >> 16


def stage_loop_reference(step: str, xr, xi, k: int, cfg: FFTConfig,
                         tables=None, epi=None):
    """Plain PyTorch version of ``stage_loop`` (any device): ``step``
    applied ``k`` times to the [n, B] tile pair.  Application i of a stage
    runs at the width ``cfg.data_width + i * (1 - cfg.scale)``, as stage i
    of a pass does; a group step runs its R stages, top order first, each
    one bit wider than the last in unscaled mode.  ``tables``: the packed stage tables (the production
    and shuffle steps); ``epi``: an [n, tc] table, tiled along B (the
    epilogue step)."""
    _check_step(step, xr, xi, k, cfg)
    s = STEPS[step]
    dt = xr.dtype
    if s.in_registers:
        for _ in range(k):
            xr, xi = _arith(s.index, xr, xi)
        return xr, xi
    xr, xi = xr.long(), xi.long()
    for i in range(k):
        if s.index == SMEM:
            h = 1 << s.order
            xr, xi = (v.reshape(-1, 2, h, v.shape[1]).flip(1).reshape(v.shape)
                      for v in (xr, xi))
        elif s.index == EPI:
            er, ei = (t.repeat(1, xr.shape[1] // t.shape[1]) for t in epi)
            xr, xi = cmult_exact(xr, xi, er, ei, cfg.twiddle_shift,
                                 cfg.data_width,
                                 twiddle_width=cfg.twiddle_width)
        else:
            xr, xi = group_reference(
                xr, xi, cfg, s.order, s.stages,
                cfg.data_width + i * s.stages * (1 - cfg.scale), tables)
    return xr.to(dt).contiguous(), xi.to(dt).contiguous()


@functools.cache
def geometry(step: str, n: int, device_index: int) -> tuple[int, int]:
    """(columns per CTA, CTAs one SM holds at once) of a step's kernel on
    an n-row tile, from the library."""
    s = STEPS[step]
    tc, ctas = ctypes.c_int(0), ctypes.c_int(0)
    lib = _build.library()
    # a fixed-mode step's two kernels share one geometry
    index = kernel_index(step, probe_config())
    err = lib.intfft_stage_probe_geometry(index, s.order, int(s.wide), n,
                                          device_index, ctypes.byref(tc),
                                          ctypes.byref(ctas))
    _build.check(lib, err, f"stage probe geometry({step})")
    return tc.value, ctas.value


def stage_loop(step: str, xr, xi, k: int, cfg: FFTConfig, tables=None,
               epi=None, once: bool = False):
    """``step`` applied ``k`` times to the [n, B] tile pair ``xr``, ``xi``
    (contiguous int32; int64 for the int64-tile steps), with the numerics
    of ``cfg``.  A CUDA tensor launches ``stage_loop_kernel`` of
    ``csrc/probe_stages.cu`` (``once``: ``stage_once_kernel``, one
    application) on the current stream, no synchronisation, and adds one to
    ``stage_loop.launches``; B must be a multiple of the tile's columns
    (``geometry``).  A CPU tensor runs ``stage_loop_reference``."""
    if once:
        k = 1
    _check_step(step, xr, xi, k, cfg)
    dev = xr.device
    if not use_kernel(dev):
        return stage_loop_reference(step, xr, xi, k, cfg, tables, epi)
    s = STEPS[step]
    tc, _ = geometry(step, cfg.n, dev.index)
    # the tables a step reads: [n] stage tables, or the [n, tc] epilogue
    tables = tables if s.index in READS_TABLES else None
    epi = epi if s.index == EPI else None
    for what, pair, shape, needed in (
            ("tables", tables, (cfg.n,), s.index in READS_TABLES),
            ("epi", epi, (cfg.n, tc), s.index == EPI)):
        if needed and (pair is None or any(
                tuple(t.shape) != shape or t.dtype != torch.int32
                or t.device != dev or not t.is_contiguous() for t in pair)):
            raise ValueError(f"step {step} takes {what}: contiguous int32 "
                             f"{shape} on {dev}")
    if (not xr.is_contiguous() or not xi.is_contiguous()
            or xr.shape[1] == 0 or xr.shape[1] % tc):
        raise ValueError(f"the stage kernels take contiguous [n, B] tiles, "
                         f"B a multiple of {tc}, got {tuple(xr.shape)}")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    ptr = lambda pair, j: None if pair is None else pair[j].data_ptr()
    lib = _build.library()
    err = lib.intfft_stage_probe(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
        ptr(tables, 0), ptr(tables, 1), ptr(epi, 0), ptr(epi, 1), cfg.n,
        xr.shape[1], kernel_index(step, cfg), s.order,
        int(s.wide), k, int(once), cfg.data_width, cfg.scale,
        int(cfg.rounding == "round"), cfg.twiddle_shift, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"stage_loop({step}) launch")
    stage_loop.launches += 1
    return yr, yi


#: Kernel launches made by ``stage_loop`` and ``stage_once`` (a plain
#: count; reset it to 0).
stage_loop.launches = 0


def stage_once(step: str, xr, xi, cfg: FFTConfig, tables=None, epi=None):
    """One application of ``step``: ``stage_once_kernel`` on a CUDA tensor,
    ``stage_loop_reference`` at k = 1 on a CPU tensor."""
    return stage_loop(step, xr, xi, 1, cfg, tables, epi, once=True)


# ------------------------------------------------------------ measurement

class StageReading(NamedTuple):
    """One timed step: sample-stages per second over the whole range of
    loop lengths and over its two halves, the three lengths, and the median
    launch times (ms) at them."""
    step: str
    per_s: float
    per_s_lo: float
    per_s_hi: float
    ks: tuple
    ms: tuple

    @property
    def ns_per_sample_per_stage(self) -> float:
        return 1e9 / self.per_s


def stage_input(step: str, cfg: FFTConfig, device=None, seed: int = 0):
    """The [n, B] tile pair a step is timed and checked on: B fills the
    card (tile columns x the CTAs an SM holds x the SMs), values of
    ``cfg.data_width`` - 1 bits that differ per element (from ``seed``)."""
    device = probe_vpu._card(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tc, ctas = geometry(step, cfg.n, device.index)
    gen = torch.Generator(device=device).manual_seed(seed)
    lim = 1 << (cfg.data_width - 2)
    dt = torch.int64 if STEPS[step].wide else torch.int32
    return tuple(torch.randint(-lim, lim, (cfg.n, tc * ctas * sms), dtype=dt,
                               device=device, generator=gen)
                 for _ in range(2))


def stage_rate(step: str, cfg: FFTConfig | None = None,
               target_ms: float = probe_vpu.TARGET_MS, reps: int = 7,
               device=None) -> StageReading:
    """Time ``stage_loop(step, x, k)`` at three loop lengths on a tile that
    fills the card and return the marginal rate: samples x (k_hi - k_lo) /
    (t_hi - t_lo) (``probe_vpu.timed_lengths``)."""
    device = probe_vpu._card(device)
    cfg = probe_config() if cfg is None else cfg
    xr, xi = stage_input(step, cfg, device)
    tables = stage_tables(cfg, device)
    epi = epilogue_table(cfg, geometry(step, cfg.n, device.index)[0], device)
    ks, rounds = probe_vpu.timed_lengths(
        lambda k: stage_loop(step, xr, xi, k, cfg, tables, epi), target_ms,
        reps, K_BASE)
    return StageReading(
        step, *probe_vpu.marginal_rates(xr.numel() * STEPS[step].stages, ks,
                                        rounds), ks,
        tuple(probe_vpu._median(col) for col in zip(*rounds)))


def check_reading(r: StageReading, peak: float):
    """The two guards of a stage reading; raises GuardError when one fails.
    ``peak``: ``probe_vpu.lane_rate_peak``."""
    if abs(r.per_s_lo - r.per_s_hi) > LINEAR_TOL * r.per_s:
        raise GuardError(
            f"step {r.step}: time is not linear in the loop length (ms "
            f"{r.ms} at {r.ks}; {r.per_s_lo:.4g} and {r.per_s_hi:.4g} "
            f"sample-stages/s over the two half-ranges)")
    if r.per_s <= 0:
        raise GuardError(f"step {r.step}: no time between the loop lengths")
    if r.step.startswith(("prod", "group")) and r.per_s > peak / ARITH12_OPS:
        raise GuardError(
            f"step {r.step}: {r.per_s:.4g} sample-stages/s is above "
            f"{peak / ARITH12_OPS:.4g} (lanes x clock / {ARITH12_OPS} "
            f"instructions per sample): a folded loop, not a fast stage")


def check_k(step: str, cfg: FFTConfig) -> int:
    """The applications a comparison of ``step`` loops: ``MAX_CHECK_K``, or
    as many as the tile holds of a group step's unscaled stages."""
    s = STEPS[step]
    if cfg.scale:
        return MAX_CHECK_K
    room = (64 if s.wide else 32) - cfg.data_width
    return min(MAX_CHECK_K, room // s.stages)


def bit_checks(device=None, n: int = 256, steps=None) -> dict:
    """Every step (of ``steps``; all of ``STEPS`` when left out) against its
    plain version and every variant against the production step it stands
    for, on the card, at k = 1 (the once kernel) and ``check_k`` (the loop
    kernel), with two full-scale columns, on ``check_config`` and on
    ``probe_config``, the config the timed run launches.  Returns {step:
    largest absolute difference}, all zero; raises RuntimeError on the
    first mismatch."""
    device = probe_vpu._card(device)
    steps = {step: STEPS[step] for step in (STEPS if steps is None else steps)}
    worst = dict.fromkeys(steps, 0)
    for cfg in (check_config(n), probe_config(n)):
        mode = "scaled/round" if cfg.scale else "unscaled"
        tables = stage_tables(cfg, device)
        for step, s in steps.items():
            xr, xi = stage_input(step, cfg, device,
                                 seed=s.index * 16 + s.order)
            xr[:, 0], xr[::3, 0], xi[:, 1] = (-(1 << 15), (1 << 15) - 1,
                                              -(1 << 15))
            epi = epilogue_table(cfg, geometry(step, n, device.index)[0],
                                 device)
            for once, k in ((True, 1), (False, check_k(step, cfg))):
                got = stage_loop(step, xr, xi, k, cfg, tables, epi, once=once)
                against = {"its plain version": stage_loop_reference(
                    step, xr, xi, k, cfg, tables, epi)}
                if s.variant_of:
                    against[s.variant_of] = stage_loop(
                        s.variant_of, xr, xi, k, cfg, tables, epi, once=once)
                for name, want in against.items():
                    err = max(int((a.long() - b.long()).abs().max())
                              for a, b in zip(got, want))
                    worst[step] = max(worst[step], err)
                    if err:
                        raise RuntimeError(
                            f"MISMATCH: step {step} ({mode}, "
                            f"{'once' if once else 'loop'}, k = {k}) differs "
                            f"from {name} by up to {err}")
    return worst


def measure_all(quick: bool = False, device=None, emit=None,
                steps=None, check: bool = True, n: int = 256) -> dict:
    """{step: ns per sample and stage} of ``steps`` (all of ``STEPS`` when
    left out) on the tile of ``n`` rows, after ``bit_checks``
    (``check=False``: the caller has run them); each reading held to
    ``check_reading``.  ``emit(step, reading)`` is called as each
    arrives."""
    device = probe_vpu._card(device)
    if check:
        bit_checks(device, n, steps)
    peak = probe_vpu.lane_rate_peak(device)
    target = probe_vpu.TARGET_MS_QUICK if quick else probe_vpu.TARGET_MS
    out = {}
    for step in STEPS if steps is None else steps:
        r = stage_rate(step, probe_config(n), target_ms=target, device=device)
        check_reading(r, peak)
        out[step] = r.ns_per_sample_per_stage
        if emit is not None:
            emit(step, r)
    return out


def main(argv=None) -> int:
    from . import audit_sass

    argv = sys.argv[1:] if argv is None else argv
    sass = audit_sass.library_sass()

    def emit(step, r):
        per = audit_sass.summarize(audit_sass.audit_stage(step, sass))
        print(f"{step:18s} {r.ns_per_sample_per_stage * 1e3:8.3f} ps per "
              f"sample and stage; instructions per butterfly: "
              + ", ".join(f"{c} {v:g}" for c, v in per.items()),
              file=sys.stderr, flush=True)

    tall = "--tall" in argv
    out = measure_all(quick="--quick" in argv, emit=emit,
                      steps=TALL_STEPS if tall else None,
                      n=TALL_ROWS if tall else 256)
    print(json.dumps({k: round(v, 6) for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
