"""The factor pass of one CUDA kernel, and the large-n four-step transform
as two launches of it.

Counterpart of ``intfftk_tpu/ops/pallas_fft.py``: the table functions
``_pack_tables``/``_cmult_plans`` (:87-114), the stage numerics of both
directions (:174-335, :501-559), ``_FusedPass`` (:897-1125),
``_FusedFourStep`` (:1133-1379) and ``LargeFFTPlan`` (:1483-1813).

One factor pass is ``fused_pass``: every stage of one factor, forward or
inverse, over the rows of [B, R, C] blocks (or of [B, C, R] blocks read
turned), the spectrum-side reorder or none (raw order), an optional
inter-factor twiddle epilogue and an optional transposed store.
``LargeFFTPlan`` runs it twice (factor 1 with epilogue and corner turn,
then factor 2), where the TPU whole-fuses both into one Pallas kernel: a
64k block does not fit one CTA's shared memory.  The single-pass engines
of ``single_pass.py`` run it once.

``fused_pass`` launches ``csrc/fused_pass.cu`` for a CUDA tensor and runs
its plain PyTorch version ``fused_pass_reference`` for a CPU tensor; there
is no other route and no fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from intfftk_tpu.config import FFTConfig
from intfftk_tpu.golden.float_model import bitrev_indices
from intfftk_tpu.golden.twiddle import circle_twiddles_int

from ..device import use_kernel
from . import _build
from .intmath import cmult_exact
from .transform import check_narrow, fft_stages, pack_tables

#: Factor sizes one CTA holds in shared memory (``csrc/fused_pass.cu``).
MIN_ROWS, MAX_ROWS = 8, 4096


def circle_table(cfg: FFTConfig, n1: int, n2: int, inverse: bool = False,
                 order: str = "natural"):
    """Inter-factor twiddles ``W_n^m`` as [n1, n2] int32, indexed by pass
    1's stored row i and column j (``pallas_fft.py:1679-1694``):

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


def _check_pass(x_re, x_im, cfg: FFTConfig, tables, epi, transpose_in):
    check_narrow(cfg)
    if not MIN_ROWS <= cfg.n <= MAX_ROWS:
        raise ValueError(f"factor size {cfg.n} outside [{MIN_ROWS}, "
                         f"{MAX_ROWS}]")
    axis = 2 if transpose_in else 1
    for x in (x_re, x_im):
        if x.dtype not in (torch.int16, torch.int32):
            raise TypeError(f"blocks must be int16 or int32, got {x.dtype}")
        if x.dim() != 3 or x.shape[axis] != cfg.n:
            want = "[B, C, {}]" if transpose_in else "[B, {}, C]"
            raise ValueError(f"expected {want.format(cfg.n)} blocks, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("blocks must be contiguous")
    if x_im.shape != x_re.shape or x_im.dtype != x_re.dtype:
        raise ValueError("re and im blocks differ in shape or dtype")
    if x_re.dtype == torch.int16 and cfg.output_width > 16:
        raise ValueError(f"int16 blocks need a data path of <= 16 bits, "
                         f"this factor's output is {cfg.output_width}")
    dev = x_re.device
    want = [((cfg.n,), t) for t in tables]
    if epi is not None:
        want += [((cfg.n, x_re.shape[3 - axis]), t) for t in epi]
    for shape, t in want:
        if (tuple(t.shape) != shape or t.dtype != torch.int32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"table must be contiguous int32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_pass_reference(x_re, x_im, cfg: FFTConfig, tables, *, epi=None,
                         transpose_out: bool, inverse: bool = False,
                         natural: bool = True, transpose_in: bool = False):
    """Plain PyTorch version of ``fused_pass`` (any device): the eager
    stages of ``transform.fft_stages`` on the [B, C, R] view, the epilogue
    through ``intmath.cmult_exact``, then the store layout."""
    w_re, w_im = tables
    xt = (lambda x: x) if transpose_in else (lambda x: x.transpose(1, 2))
    yr, yi = fft_stages(xt(x_re), xt(x_im), cfg, w_re, w_im,
                        inverse=inverse, natural=natural)    # [B, C, R]
    if epi is not None:
        er, ei = epi
        yr, yi = cmult_exact(yr, yi, er.t(), ei.t(), cfg.twiddle_shift,
                             cfg.output_width)
    if not transpose_out:
        yr, yi = yr.transpose(1, 2), yi.transpose(1, 2)
    return (yr.to(x_re.dtype).contiguous(), yi.to(x_re.dtype).contiguous())


def fused_pass(x_re, x_im, cfg: FFTConfig, tables, *, epi=None,
               transpose_out: bool, inverse: bool = False,
               natural: bool = True, transpose_in: bool = False):
    """One factor pass along R = cfg.n of [B, R, C] blocks, or of [B, C, R]
    blocks with ``transpose_in``.

    ``tables``: the packed stage tables (w_re, w_im), int32 [R], the same
    for both directions; ``inverse``: DIT stages with the conjugate
    twiddles; ``natural``: the spectrum side in natural order (the
    forward's output, the inverse's input), else bit-reversed, the raw
    core contract; ``epi``: optional (er, ei) int32 [R, C] multiplied into
    stored row k, renormalised by ``cfg.twiddle_shift`` and wrapped to
    ``cfg.output_width``.  Returns [B, C, R] when ``transpose_out`` else
    [B, R, C], in the input's dtype (int16 or int32).

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation) and adds one to ``fused_pass.launches``; a CPU tensor
    runs ``fused_pass_reference``."""
    _check_pass(x_re, x_im, cfg, tables, epi, transpose_in)
    dev = x_re.device
    if not use_kernel(dev):
        return fused_pass_reference(x_re, x_im, cfg, tables, epi=epi,
                                    transpose_out=transpose_out,
                                    inverse=inverse, natural=natural,
                                    transpose_in=transpose_in)
    nb = x_re.shape[0]
    r = cfg.n
    c = x_re.shape[1] if transpose_in else x_re.shape[2]
    oshape = (nb, c, r) if transpose_out else (nb, r, c)
    y_re = torch.empty(oshape, dtype=x_re.dtype, device=dev)
    y_im = torch.empty(oshape, dtype=x_re.dtype, device=dev)
    e_re, e_im = ((epi[0].data_ptr(), epi[1].data_ptr()) if epi is not None
                  else (None, None))
    lib = _build.library()
    err = lib.intfft_fused_pass(
        x_re.data_ptr(), x_im.data_ptr(), y_re.data_ptr(), y_im.data_ptr(),
        tables[0].data_ptr(), tables[1].data_ptr(), e_re, e_im,
        nb, r, c, int(x_re.dtype == torch.int16), cfg.data_width, cfg.scale,
        int(cfg.rounding == "round"), cfg.twiddle_shift, int(cfg.bypass_fly),
        int(inverse), int(natural), int(transpose_in), int(transpose_out),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused_pass launch")
    fused_pass.launches += 1
    return y_re, y_im


#: Kernel launches made by ``fused_pass`` (a plain count; reset it to 0).
fused_pass.launches = 0


class LargeFFTPlan(nn.Module):
    """Large-n FFT on one device: the four-step schedule as two passes,
    numerics identical to ``golden.four_step.four_step_int`` (forward, or
    the unnormalised inverse with ``inverse=True``).

    1. pass 1: log2(n1) stages over the n1 rows of [B, n1, n2] blocks,
       times the inter-factor twiddle (``circle_table``), stored turned as
       [B, n2, n1];
    2. pass 2: log2(n2) stages over the rows of [B, n2, n1], stored as
       [B, n2, n1] (``block_out_shape``).

    ``order="natural"``: the flat views of the input and output blocks are
    in natural order; both reorders happen inside the kernel.
    ``order="raw"``: the spectrum side of both passes is bit-reversed (the
    raw core contract, no reorder anywhere): a raw forward's output block
    is exactly the input block of the raw inverse with swapped factors
    (n1' = n2, n2' = n1), and ``raw_spectrum_order()`` maps its flat
    positions to natural bins.

    Blocks are int16 when every width on the data path fits 16 bits
    (``io16``, as ``pallas_fft.py:1566-1570``), else int32.  The stage and
    epilogue tables are buffers on ``device``.

    Not ported yet (raise NotImplementedError, see ROADMAP Queue A):
    ``schedule="monolithic"``, ``epi_synth`` and data paths wider than 32
    bits.
    """

    def __init__(self, cfg: FFTConfig, n1: int | None = None,
                 n2: int | None = None, *, inverse: bool = False,
                 order: str = "natural", schedule: str = "fourstep",
                 epi_synth: bool = False,
                 device: torch.device | str | None = None):
        super().__init__()
        if order not in ("natural", "raw"):
            raise ValueError(f"bad order {order!r}")
        if schedule not in ("fourstep", "monolithic"):
            raise ValueError(f"bad schedule {schedule!r}")
        if schedule == "monolithic":
            raise NotImplementedError(
                "the monolithic schedule is not ported yet: ROADMAP Queue "
                "A, 'Monolithic schedule'")
        if epi_synth:
            raise NotImplementedError(
                "in-kernel twiddle synthesis is not ported yet: ROADMAP "
                "Queue A, 'Split pipeline'")
        n = cfg.n
        if n1 is None or n2 is None:
            # the JAX plan's balanced split: n2 = 2^max(7, stages // 2)
            n2 = 1 << max(7, cfg.stages // 2)
            n1 = n // n2
        if (n1 * n2 != n or not MIN_ROWS <= n1 <= MAX_ROWS
                or not MIN_ROWS <= n2 <= MAX_ROWS):
            raise ValueError(f"bad factors {n1}x{n2} for n={n}")
        self.cfg, self.n1, self.n2 = cfg, n1, n2
        self.inverse, self.order = inverse, order
        self.cfg1 = dataclasses.replace(cfg, n=n1)
        w1 = self.cfg1.output_width
        self.cfg2 = dataclasses.replace(cfg, n=n2, data_width=w1)
        check_narrow(self.cfg2)       # its output is the widest width
        self.io16 = max(cfg.data_width, w1, self.cfg2.output_width) <= 16
        self.io_dtype = torch.int16 if self.io16 else torch.int32

        w1r, w1i = pack_tables(self.cfg1)
        w2r, w2i = pack_tables(self.cfg2)
        er, ei = circle_table(cfg, n1, n2, inverse, order)
        for name, arr in (("w1r", w1r), ("w1i", w1i), ("w2r", w2r),
                          ("w2i", w2i), ("er", er), ("ei", ei)):
            self.register_buffer(name, torch.as_tensor(arr, device=device))

    @property
    def block_in_shape(self):
        """[R, C] of one input block of ``apply_blocks``: (n1, n2); a flat
        natural-order [n] buffer reshapes to it for free."""
        return (self.n1, self.n2)

    @property
    def block_out_shape(self):
        """[R, C] of one output block: (n2, n1), whose flat view is the
        natural-order output (the raw spectrum with ``order="raw"``)."""
        return (self.n2, self.n1)

    def raw_spectrum_order(self) -> np.ndarray:
        """The raw spectrum layout (``pallas_fft.py:1697-1719``): flat
        position j of a raw forward's output, which is a swapped-factor
        raw inverse's input, holds natural bin ``raw_spectrum_order()[j]``.
        Permute frequency-domain tables by it before pointwise use against
        raw-chained transforms."""
        rev1, rev2 = bitrev_indices(self.n1), bitrev_indices(self.n2)
        if self.inverse:
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

    def apply_blocks(self, xr, xi):
        """[B, n1, n2] blocks in ``io_dtype`` -> [B, n2, n1] blocks: two
        ``fused_pass`` calls, every reorder inside them."""
        kw = dict(inverse=self.inverse, natural=self.order == "natural")
        br, bi = fused_pass(xr, xi, self.cfg1, (self.w1r, self.w1i),
                            epi=(self.er, self.ei), transpose_out=True, **kw)
        return fused_pass(br, bi, self.cfg2, (self.w2r, self.w2i),
                          transpose_out=False, **kw)

    def forward(self, x_re, x_im):
        """Flat [B, n] integers -> flat [B, n] in ``io_dtype``, on the
        device of the input (natural order, or the raw layout of
        ``block_in_shape``/``block_out_shape`` with ``order="raw"``)."""
        if x_re.dim() != 2 or x_re.shape[-1] != self.cfg.n:
            raise ValueError(f"expected [B, n={self.cfg.n}], got "
                             f"{tuple(x_re.shape)}")
        nb = x_re.shape[0]
        blk = lambda x: x.to(self.io_dtype).reshape(
            (nb,) + self.block_in_shape).contiguous()
        yr, yi = self.apply_blocks(blk(x_re), blk(x_im))
        return yr.reshape(nb, self.cfg.n), yi.reshape(nb, self.cfg.n)
