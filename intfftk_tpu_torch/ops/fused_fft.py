"""The factor pass of one CUDA kernel, and the large-n transform as two
launches of it.

Counterpart of ``intfftk_tpu/ops/pallas_fft.py``: the table functions
``_pack_tables``/``_cmult_plans`` (:87-114), the stage numerics of both
directions (:174-335, :501-559), the monolithic schedule's 2-D stages
(:340-430), ``_FusedPass`` (:897-1125), ``_FusedFourStep`` (:1133-1379)
and ``LargeFFTPlan`` (:1483-1813).

One factor pass is ``fused_pass``: every stage of one factor, forward or
inverse, over the rows of [B, R, C] blocks (or of [B, C, R] blocks read
turned), the spectrum-side reorder or none (raw order), an optional
inter-factor twiddle epilogue (from a table, or synthesized in the kernel
from the coarse table) and an optional transposed store; with 2-D stage
tables, the stages of the monolithic schedule's i1 factor.
``LargeFFTPlan`` runs it twice, where the TPU whole-fuses both factors
into one Pallas kernel up to its VMEM knee and splits them above it: a
64k block does not fit one CTA's shared memory, so the port's pipeline is
always the split one.  The single-pass engines of ``single_pass.py`` run
it once.

Data paths wider than 32 bits (the JAX ``wide_in``/``wide1``/``wide2``
forms, carried there as two int32 planes) are int64 blocks here: a pass
reads int16, int32 or int64 and stores int16, int32 or int64
(``PASS_DTYPES``), widening int32 -> int64 in the kernel where its data
path first outgrows 32 bits.

``fused_pass`` launches ``csrc/fused_pass.cu`` for a CUDA tensor and runs
its plain PyTorch version ``fused_pass_reference`` for a CPU tensor; there
is no other route and no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
from torch import nn

from ..config import FFTConfig
from ..golden.float_model import bitrev_indices
from ..golden.twiddle import circle_twiddles_int

from ..device import resolve, use_kernel
from . import _build
from .intmath import cmult_exact
from .transform import (check_width, fft_stages, fft_stages_2d, pack_tables,
                        pack_tables_2d)
from .twiddle_synth import (EpiSynth, can_synth, check_block, coarse_table,
                            device_circle_table, synth_circle_block,
                            synth_params)

#: Factor sizes one CTA holds in shared memory (``csrc/fused_pass.cu``).
MIN_ROWS, MAX_ROWS = 8, 4096
#: Largest monolithic transform: the reference core's own limit
#: (``int_fftNk.vhd:12``).
MAX_MONOLITHIC = 1 << 19
#: Where a four-step plan's inter-factor twiddles come from.
EPI_MODES = ("auto", "host", "device", "inkernel")
#: The (input, output) block dtypes of one pass: narrow with int16 or int32
#: storage, widening, and wide.
PASS_DTYPES = ((torch.int16, torch.int16), (torch.int32, torch.int32),
               (torch.int32, torch.int64), (torch.int64, torch.int64))


def block_dtype(width: int, io16: bool) -> torch.dtype:
    """Block dtype of data of ``width`` bits: int64 above 32 bits, int16
    where the whole plan fits 16 (``io16``), else int32."""
    if width > 32:
        return torch.int64
    return torch.int16 if io16 else torch.int32


def circle_table(cfg: FFTConfig, n1: int, n2: int, inverse: bool = False,
                 order: str = "natural"):
    """Inter-factor twiddles ``W_n^m`` as [n1, n2] int32, built on the host
    and indexed by pass 1's stored row i and column j
    (``pallas_fft.py:1679-1694``):

    * natural: m = k1*j2, negated for the inverse;
    * raw forward: row i holds k1 = rev1[i], so m = rev1[i]*j2;
    * raw inverse: the columns arrive bit-reversed, m = -(k1*rev2[j])."""
    wc_re, wc_im = circle_twiddles_int(cfg.n, cfg.twiddle_width,
                                       cfg.twiddle_gen)
    i, j = np.arange(n1)[:, None], np.arange(n2)[None, :]
    if order == "natural":
        m = -(i * j) if inverse else i * j
    elif inverse:
        m = -(i * bitrev_indices(n2)[None, :])
    else:
        m = bitrev_indices(n1)[:, None] * j
    m = m % cfg.n
    return wc_re[m].astype(np.int32), wc_im[m].astype(np.int32)


def _check_pass(x_re, x_im, cfg: FFTConfig, tables, epi, synth, tables_2d,
                natural, transpose_in, out_dtype):
    check_width(cfg)
    if not MIN_ROWS <= cfg.n <= MAX_ROWS:
        raise ValueError(f"factor size {cfg.n} outside [{MIN_ROWS}, "
                         f"{MAX_ROWS}]")
    if (tables is None) == (tables_2d is None):
        raise ValueError("give either the stage tables or the 2-D tables")
    if epi is not None and synth is not None:
        raise ValueError("give either an epilogue table or synth")
    axis = 2 if transpose_in else 1
    if (x_re.dtype, out_dtype) not in PASS_DTYPES:
        raise TypeError(f"a pass takes (in, out) blocks {PASS_DTYPES}, got "
                        f"({x_re.dtype}, {out_dtype})")
    for x in (x_re, x_im):
        if x.dim() != 3 or x.shape[axis] != cfg.n:
            want = "[B, C, {}]" if transpose_in else "[B, {}, C]"
            raise ValueError(f"expected {want.format(cfg.n)} blocks, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("blocks must be contiguous")
    if x_im.shape != x_re.shape or x_im.dtype != x_re.dtype:
        raise ValueError("re and im blocks differ in shape or dtype")
    bits = torch.iinfo(out_dtype).bits
    if cfg.output_width > bits:
        raise ValueError(f"{out_dtype} blocks hold <= {bits} "
                         f"bits, this factor's output is {cfg.output_width}")
    if out_dtype == torch.int64 and (synth is not None
                                     or tables_2d is not None):
        raise ValueError("int64 blocks take neither the in-kernel synthesis "
                         "nor the 2-D stage tables (the JAX package has "
                         "no wide form of either)")
    dev = x_re.device
    cols = x_re.shape[3 - axis]
    want = []
    if tables is not None:
        want += [((cfg.n,), t) for t in tables]
    if tables_2d is not None:
        want += [((cfg.n, cols), t) for t in tables_2d]
    if epi is not None:
        want += [((cfg.n, cols), t) for t in epi]
    if synth is not None:
        if not natural:
            raise ValueError("in-kernel synthesis needs natural order")
        check_block(cfg.n, cols, 0, synth.n)
        synth_params(cfg, synth.n)
        want += [((512,), t) for t in (synth.re, synth.im)]
    for shape, t in want:
        if (tuple(t.shape) != shape or t.dtype != torch.int32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"table must be contiguous int32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_pass_reference(x_re, x_im, cfg: FFTConfig, tables, *, epi=None,
                         synth: EpiSynth | None = None, tables_2d=None,
                         transpose_out: bool, inverse: bool = False,
                         natural: bool = True, transpose_in: bool = False,
                         out_dtype: torch.dtype | None = None):
    """Plain PyTorch version of ``fused_pass`` (any device): the eager
    stages of ``transform.fft_stages`` (or ``fft_stages_2d``) on the
    [B, C, R] view, the epilogue (``synth``: its table from
    ``synth_circle_block``) through ``intmath.cmult_exact``, then the store
    layout and dtype."""
    xt = (lambda x: x) if transpose_in else (lambda x: x.transpose(1, 2))
    if tables_2d is not None:
        yr, yi = fft_stages_2d(xt(x_re), xt(x_im), cfg, *tables_2d,
                               inverse=inverse, natural=natural)
    else:
        yr, yi = fft_stages(xt(x_re), xt(x_im), cfg, *tables,
                            inverse=inverse, natural=natural)  # [B, C, R]
    if synth is not None:
        epi = synth_circle_block((synth.re, synth.im), cfg.n, yr.shape[1],
                                 0, synth.n, cfg, inverse)
    if epi is not None:
        er, ei = epi
        yr, yi = cmult_exact(yr, yi, er.t(), ei.t(), cfg.twiddle_shift,
                             cfg.output_width,
                             twiddle_width=cfg.twiddle_width)
    if not transpose_out:
        yr, yi = yr.transpose(1, 2), yi.transpose(1, 2)
    dt = out_dtype or x_re.dtype
    return yr.to(dt).contiguous(), yi.to(dt).contiguous()


def fused_pass(x_re, x_im, cfg: FFTConfig, tables, *, epi=None,
               synth: EpiSynth | None = None, tables_2d=None,
               transpose_out: bool, inverse: bool = False,
               natural: bool = True, transpose_in: bool = False,
               out_dtype: torch.dtype | None = None):
    """One factor pass along R = cfg.n of [B, R, C] blocks, or of [B, C, R]
    blocks with ``transpose_in``.

    ``tables``: the packed stage tables (w_re, w_im), int32 [R], the same
    for both directions; or None with ``tables_2d``: (t_re, t_im) int32
    [R, C] of ``pack_tables_2d``, where every stage multiplies by its
    column's full-size twiddle (the monolithic schedule's i1 factor).
    ``inverse``: DIT stages with the conjugate twiddles; ``natural``: the
    spectrum side in natural order (the forward's output, the inverse's
    input), else bit-reversed, the raw core contract.  The epilogue
    multiplies stored row k, column j by a twiddle renormalised by
    ``cfg.twiddle_shift`` and wrapped to ``cfg.output_width``: ``epi``,
    (er, ei) int32 [R, C] tables; or ``synth``, W_n^(+-k*j) synthesized
    in the kernel from the coarse table (natural order only).  Returns
    [B, C, R] when ``transpose_out`` else [B, R, C], in ``out_dtype`` (the
    input's dtype by default): int16 -> int16, int32 -> int32, int32 ->
    int64 (the widening pass) or int64 -> int64 (``PASS_DTYPES``).  int64
    blocks carry outputs up to 64 bits, with a table epilogue or none.

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation) and adds the launches made to ``fused_pass.launches``:
    one, or one for every 65 535 blocks or part of them (a grid holds no
    more); a CPU tensor runs ``fused_pass_reference``."""
    out_dtype = out_dtype or x_re.dtype
    _check_pass(x_re, x_im, cfg, tables, epi, synth, tables_2d, natural,
                transpose_in, out_dtype)
    dev = x_re.device
    if not use_kernel(dev):
        return fused_pass_reference(x_re, x_im, cfg, tables, epi=epi,
                                    synth=synth, tables_2d=tables_2d,
                                    transpose_out=transpose_out,
                                    inverse=inverse, natural=natural,
                                    transpose_in=transpose_in,
                                    out_dtype=out_dtype)
    nb = x_re.shape[0]
    r = cfg.n
    c = x_re.shape[1] if transpose_in else x_re.shape[2]
    oshape = (nb, c, r) if transpose_out else (nb, r, c)
    y_re = torch.empty(oshape, dtype=out_dtype, device=dev)
    y_im = torch.empty(oshape, dtype=out_dtype, device=dev)
    ptrs = lambda pair: ((pair[0].data_ptr(), pair[1].data_ptr())
                         if pair is not None else (None, None))
    prm = synth_params(cfg, synth.n) if synth is not None else (0, 0, 0, 0)
    lib = _build.library()
    made = ctypes.c_int(0)
    err = lib.intfft_fused_pass(
        x_re.data_ptr(), x_im.data_ptr(), y_re.data_ptr(), y_im.data_ptr(),
        *ptrs(tables), *ptrs(tables_2d), *ptrs(epi),
        *ptrs(synth[:2] if synth is not None else None),
        nb, r, c, x_re.element_size(), y_re.element_size(), cfg.data_width,
        cfg.scale,
        int(cfg.rounding == "round"), cfg.twiddle_shift, int(cfg.bypass_fly),
        int(inverse), int(natural), int(transpose_in), int(transpose_out),
        *prm, dev.index, torch.cuda.current_stream(dev).cuda_stream,
        ctypes.byref(made))
    _build.check(lib, err, "fused_pass launch")
    fused_pass.launches += made.value
    return y_re, y_im


#: Kernel launches made by ``fused_pass`` (a plain count; reset it to 0).
fused_pass.launches = 0


class LargeFFTPlan(nn.Module):
    """Large-n FFT on one device as two ``fused_pass`` launches.

    ``schedule="fourstep"`` (default): numerics identical to
    ``golden.four_step.four_step_int`` (forward, or the unnormalised
    inverse with ``inverse=True``):

    1. pass 1: log2(n1) stages over the n1 rows of [B, n1, n2] blocks,
       times the inter-factor twiddle, stored turned as [B, n2, n1];
    2. pass 2: log2(n2) stages over the rows of [B, n2, n1], stored as
       [B, n2, n1] (``block_out_shape``).

    ``epi_synth`` picks where the inter-factor twiddle comes from
    (``pallas_fft.py:1608-1678``); ``epi_mode`` says which was taken:

    * ``"host"``: an [n1, n2] table built on the host (``circle_table``)
      and uploaded;
    * ``"device"``: the same table generated on the plan's device from the
      4 KiB coarse table, once, at build (``device_circle_table``);
    * ``"inkernel"``: no table: pass 1 synthesizes each twiddle in its
      epilogue from the coarse table, on every call; the plan holds no
      ``er``/``ei``;
    * ``"auto"``: ``"device"`` where ``can_synth(cfg, order)`` holds and
      pass 1 is narrow, else ``"host"``.  ``"device"`` and ``"inkernel"``
      raise ValueError where it does not hold (raw order, twiddles wider
      than 16 bits, ROM twiddles, n < 4096) and under ``wide1``: the JAX
      plan never synthesizes for a wide pass 1 (``pallas_fft.py:1617``).

    ``schedule="monolithic"`` (n <= 512K): bits identical to the single
    full-size core, ``golden.fft_int`` (per-stage rounding, full-size
    twiddle stream, no epilogue; ``pallas_fft.py:1159-1253``):

    * forward: pass 1 runs the log2(n1) leading stages over the n1 rows of
      [B, n1, n2] with the 2-D tables (``pack_tables_2d``), stored turned;
      pass 2 is the standard n2 factor;
    * inverse: input blocks are [B, n2, n1] (``block_in_shape``); pass 1
      is the standard n2 factor, stored turned; pass 2 runs the log2(n1)
      remaining stages with the 2-D tables; output blocks [B, n1, n2].

    The i1-axis bit-reversal that the JAX plan applies as a separate lane
    gather is the 2-D pass's own reorder here (its store in the forward,
    its load in the inverse).

    ``order="natural"``: the flat views of the input and output blocks are
    in natural order; every reorder happens inside the kernel.
    ``order="raw"``: the spectrum side of both passes is bit-reversed (the
    raw core contract, no reorder anywhere), and ``raw_spectrum_order()``
    maps flat positions to natural bins.  A four-step raw forward's output
    block is the input block of the raw inverse with swapped factors
    (n1' = n2, n2' = n1); a monolithic raw forward's is the input block of
    the monolithic raw inverse with the same factors.

    Blocks are int16 when every width on the data path fits 16 bits
    (``io16``, as ``pallas_fft.py:1566-1570``), else int32; a side wider
    than 32 bits is int64 (``pallas_fft.py:1563-1565``):
    the input under ``wide_in`` (data wider than 32 bits), pass 1's output
    under ``wide1``, pass 2's under ``wide2``.  ``in_dtype`` and
    ``out_dtype`` are the blocks of ``apply_blocks``.  Outputs wider than
    64 bits raise NotImplementedError, and so does the monolithic schedule
    on a data path wider than 32 bits, as in JAX
    (``pallas_fft.py:1167-1171``).  The tables are buffers on ``device``:
    the current CUDA device unless the caller names one (``device="cpu"``
    for the plain version; ``device.resolve``).
    """

    def __init__(self, cfg: FFTConfig, n1: int | None = None,
                 n2: int | None = None, *, inverse: bool = False,
                 order: str = "natural", schedule: str = "fourstep",
                 epi_synth: str = "auto",
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve(device)
        if order not in ("natural", "raw"):
            raise ValueError(f"bad order {order!r}")
        if schedule not in ("fourstep", "monolithic"):
            raise ValueError(f"bad schedule {schedule!r}")
        if epi_synth not in EPI_MODES:
            raise ValueError(f"bad epi_synth {epi_synth!r}, one of "
                             f"{EPI_MODES}")
        n = cfg.n
        if n1 is None or n2 is None:
            # the JAX plan's balanced split: n2 = 2^max(7, stages // 2)
            n2 = 1 << max(7, cfg.stages // 2)
            n1 = n // n2
        if (n1 * n2 != n or not MIN_ROWS <= n1 <= MAX_ROWS
                or not MIN_ROWS <= n2 <= MAX_ROWS):
            raise ValueError(f"bad factors {n1}x{n2} for n={n}")
        self.cfg, self.n1, self.n2 = cfg, n1, n2
        self.inverse, self.order, self.schedule = inverse, order, schedule
        tables = {}
        if schedule == "monolithic":
            if n > MAX_MONOLITHIC:
                raise ValueError(
                    f"the monolithic schedule reaches n = {MAX_MONOLITHIC}, "
                    f"the reference core's limit (int_fftNk.vhd:12); got "
                    f"n = {n}: use schedule='fourstep'")
            if epi_synth != "auto":
                raise ValueError("the monolithic schedule has no "
                                 "inter-factor twiddle: leave epi_synth")
            self.epi_mode = None
            # pass 1 takes the factor its stages reach first: the 2-D i1
            # factor forward, the standard i2 factor inverse (DIT ascends)
            first, second = (n2, n1) if inverse else (n1, n2)
            self.cfg1 = dataclasses.replace(cfg, n=first)
            self.cfg2 = dataclasses.replace(
                cfg, n=second, data_width=self.cfg1.output_width)
            if self.cfg2.output_width > 32:
                raise NotImplementedError(
                    "the monolithic schedule carries data paths of <= 32 "
                    "bits, as the JAX one does; use schedule='fourstep' or "
                    "the staged WideFFTPlan")
            std = self.cfg1 if inverse else self.cfg2
            tables["wsr"], tables["wsi"] = pack_tables(std)
            tables["t2r"], tables["t2i"] = pack_tables_2d(cfg, n1, n2)
        else:
            self.cfg1 = dataclasses.replace(cfg, n=n1)
            self.cfg2 = dataclasses.replace(
                cfg, n=n2, data_width=self.cfg1.output_width)
            check_width(self.cfg2)        # its output is the widest width
            synth_ok = (can_synth(cfg, order)
                        and self.cfg1.output_width <= 32)
            mode = (("device" if synth_ok else "host")
                    if epi_synth == "auto" else epi_synth)
            if mode != "host" and not synth_ok:
                raise ValueError(
                    f"epi_synth={mode!r} needs natural order, Taylor "
                    f"twiddles of <= 16 bits, n >= 4096 (can_synth) and a "
                    f"pass 1 of <= 32 bits")
            self.epi_mode = mode
            tables["w1r"], tables["w1i"] = pack_tables(self.cfg1)
            tables["w2r"], tables["w2i"] = pack_tables(self.cfg2)
            if mode == "host":
                tables["er"], tables["ei"] = circle_table(cfg, n1, n2,
                                                          inverse, order)
            elif mode == "device":
                tables["er"], tables["ei"] = device_circle_table(
                    cfg, n, n1, n2, inverse, device)
            else:
                tables["coarse_re"], tables["coarse_im"] = coarse_table(cfg)
        self.io16 = max(cfg.data_width, self.cfg1.output_width,
                        self.cfg2.output_width) <= 16
        self.wide_in = cfg.data_width > 32
        self.wide1 = self.cfg1.output_width > 32
        self.wide2 = self.cfg2.output_width > 32
        self.in_dtype = block_dtype(cfg.data_width, self.io16)
        self.mid_dtype = block_dtype(self.cfg1.output_width, self.io16)
        self.out_dtype = block_dtype(self.cfg2.output_width, self.io16)
        for name, arr in tables.items():
            self.register_buffer(name, torch.as_tensor(arr, device=device))

    @property
    def _mono_inverse(self) -> bool:
        return self.schedule == "monolithic" and self.inverse

    @property
    def block_in_shape(self):
        """[R, C] of one input block of ``apply_blocks``: (n1, n2), or
        (n2, n1) for the monolithic inverse; a flat natural-order [n]
        buffer reshapes to it for free."""
        return (self.n2, self.n1) if self._mono_inverse else (self.n1,
                                                              self.n2)

    @property
    def block_out_shape(self):
        """[R, C] of one output block: (n2, n1), or (n1, n2) for the
        monolithic inverse; its flat view is the natural-order output (the
        raw spectrum with ``order="raw"``)."""
        return (self.n1, self.n2) if self._mono_inverse else (self.n2,
                                                              self.n1)

    def raw_spectrum_order(self) -> np.ndarray:
        """The raw spectrum layout (``pallas_fft.py:1697-1719``): flat
        position j of a raw forward's output, or of a raw inverse's input,
        holds natural bin ``raw_spectrum_order()[j]``.  Permute
        frequency-domain tables by it before pointwise use against
        raw-chained transforms.  The monolithic inverse consumes exactly
        its forward's layout (the JAX plan's table for it differs when
        n1 != n2; ROADMAP §C)."""
        rev1, rev2 = bitrev_indices(self.n1), bitrev_indices(self.n2)
        if self.inverse and self.schedule == "fourstep":
            return (rev1[:, None] * self.n2 + rev2[None, :]).reshape(-1)
        return (rev2[:, None] * self.n1 + rev1[None, :]).reshape(-1)

    def load_tables(self, tables: dict[str, torch.Tensor]):
        """Copy in stage and epilogue tables (``convert.tables_from_jax``);
        each must match its buffer's shape."""
        bufs = dict(self.named_buffers())
        for name, t in tables.items():
            buf = bufs.get(name)
            if buf is None or tuple(t.shape) != tuple(buf.shape):
                raise ValueError(f"table {name} {tuple(t.shape)} matches no "
                                 f"buffer of this plan")
            buf.copy_(t)

    def passes(self):
        """The two passes of ``apply_blocks`` as (cfg, keyword arguments of
        ``fused_pass``), in launch order."""
        kw = dict(inverse=self.inverse, natural=self.order == "natural")
        if self.schedule == "monolithic":
            std = dict(tables=(self.wsr, self.wsi))
            two_d = dict(tables=None, tables_2d=(self.t2r, self.t2i))
            one, two = (std, two_d) if self.inverse else (two_d, std)
        else:
            if self.epi_mode == "inkernel":
                epi = dict(synth=EpiSynth(self.coarse_re, self.coarse_im,
                                          self.cfg.n))
            else:
                epi = dict(epi=(self.er, self.ei))
            one = dict(tables=(self.w1r, self.w1i), **epi)
            two = dict(tables=(self.w2r, self.w2i))
        return [(self.cfg1, dict(one, transpose_out=True,
                                 out_dtype=self.mid_dtype, **kw)),
                (self.cfg2, dict(two, transpose_out=False,
                                 out_dtype=self.out_dtype, **kw))]

    def apply_blocks(self, xr, xi, pass_fn=fused_pass):
        """[B, *block_in_shape] blocks in ``in_dtype`` -> [B,
        *block_out_shape] blocks in ``out_dtype``: two ``fused_pass``
        calls, every reorder inside them (``pass_fn=fused_pass_reference``:
        the plain version on any device)."""
        for cfg, kw in self.passes():
            xr, xi = pass_fn(xr, xi, cfg, **kw)
        return xr, xi

    def forward(self, x_re, x_im):
        """Flat [B, n] integers -> flat [B, n] in ``out_dtype``, on the
        device of the input (natural order, or the raw layout of
        ``block_in_shape``/``block_out_shape`` with ``order="raw"``)."""
        if x_re.dim() != 2 or x_re.shape[-1] != self.cfg.n:
            raise ValueError(f"expected [B, n={self.cfg.n}], got "
                             f"{tuple(x_re.shape)}")
        nb = x_re.shape[0]
        blk = lambda x: x.to(self.in_dtype).reshape(
            (nb,) + self.block_in_shape).contiguous()
        yr, yi = self.apply_blocks(blk(x_re), blk(x_im))
        return yr.reshape(nb, self.cfg.n), yi.reshape(nb, self.cfg.n)
