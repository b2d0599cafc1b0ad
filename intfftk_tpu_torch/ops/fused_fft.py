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
``LargeFFTPlan`` runs it twice (``fuse="split"``), or runs both factors
in one launch of ``fused_whole`` (``fuse="whole"``): the TPU whole-fuses
them into one Pallas kernel up to its VMEM knee; a 64k block does not fit
one CTA's shared memory, so the whole form is a thread-block cluster per
item whose corner turn crosses distributed shared memory
(``csrc/fused_whole.cuh``), narrow or wide, and ``fuse="auto"`` takes the
narrow form where the card's tuning row says it beat the split.  The
single-pass engines of ``single_pass.py`` run the pass once.

Data paths wider than 32 bits (the JAX ``wide_in``/``wide1``/``wide2``
forms, carried there as two int32 planes) are int64 blocks here: a pass
reads int16, int32 or int64 and stores int16, int32 or int64
(``PASS_DTYPES``), widening int32 -> int64 in the kernel where its data
path first outgrows 32 bits.

``fused_pass`` launches ``csrc/fused_pass.cu`` for a CUDA tensor and runs
its plain PyTorch version ``fused_pass_reference`` for a CPU tensor, and
``fused_whole`` the cluster kernel or ``fused_four_step_reference`` (the
two passes' plain versions in turn); there is no other route and no
fallback.  A plan's call does not go through
``fused_pass`` on the card: its passes are prepared once per input
(shape, dtype, device) as a ``PreparedChain`` (the checks and the C
prepare step, ``intfft_prepare_pass``), and each call launches them all in
one C call (``intfft_fused_chain``), the host's whole cost of a call where
``fused_pass`` checked, resolved and issued each pass anew.  The plans'
``capture()`` records that call into a CUDA graph (``runtime/graph.py``).
The launch geometry of a pass (threads per CTA, TC columns per CTA) comes
from the card's tuning row (``ops/tuning.py``):
a plan resolves it once, at build, records the row as ``plan.tuning`` and
hands each pass its geometry; the bits do not depend on it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import threading
import types
import weakref

import numpy as np
import torch
from torch import nn

from ..config import TAYLOR_COARSE_BITS, FFTConfig
from ..golden.float_model import bitrev_indices
from ..golden.twiddle import circle_twiddles_int

from ..device import resolve, stream_handle, use_kernel
from ..runtime import trace
from . import _build
from .intmath import cmult_exact
from .transform import (check_width, fft_stages, fft_stages_2d, pack_tables,
                        pack_tables_2d)
from .tuning import (MAX_CLUSTER, device_tuning, pass_geometry,
                     tile_skew, whole_candidates, whole_capacity,
                     whole_cluster, whole_launch, whole_shape)
from .twiddle_synth import (TABLE_ENTRY_BYTES, EpiSynth, can_synth,
                            check_block, coarse_table, device_circle_table,
                            synth_circle_block, synth_params)

#: Factor sizes one CTA holds in shared memory (``csrc/fused_pass.cu``).
MIN_ROWS, MAX_ROWS = 8, 4096
#: Largest monolithic transform: the reference core's own limit
#: (``int_fftNk.vhd:12``).
MAX_MONOLITHIC = 1 << 19
#: Where a four-step plan's inter-factor twiddles come from.
EPI_MODES = ("auto", "host", "device", "inkernel")
#: Bytes of the coarse table an in-kernel epilogue reads: two int32
#: planes of 2^TAYLOR_COARSE_BITS entries.
COARSE_BYTES = 2 * 4 << TAYLOR_COARSE_BITS
#: How a plan runs its two factors: in one launch ("whole"), in two
#: ("split"), or as the card's tuning row says ("auto").
FUSE_MODES = ("auto", "whole", "split")
#: What the C entry reports of a launch: launches made, TC, threads per CTA,
#: shared memory per CTA in bytes, CTAs along the columns, the tile's skew.
_REPORT = ctypes.c_int * 6
#: The (input, output) block dtypes of one pass: narrow with int16 or int32
#: storage, widening, and wide.
PASS_DTYPES = ((torch.int16, torch.int16), (torch.int32, torch.int32),
               (torch.int32, torch.int64), (torch.int64, torch.int64))
#: The (input, pass 1's output, output) block dtypes the whole form runs:
#: narrow, then the wide chains of the JAX kernel's wide2, wide1 and
#: wide_in (``pallas_fft.py:1268-1307``).
WHOLE_DTYPES = ((torch.int16,) * 3, (torch.int32,) * 3,
                (torch.int32, torch.int32, torch.int64),
                (torch.int32, torch.int64, torch.int64), (torch.int64,) * 3)


@dataclasses.dataclass(frozen=True)
class Edges:
    """The convolution's edges of a chain (``OverlapSaveConv``): signal rows
    of ``length`` samples cut into payloads of ``payload`` samples, each
    block the ``lead`` samples before its payload and the payload (n =
    payload + lead).  Block b of a batch is payload j = b mod ``blocks`` of
    signal row s = b div ``blocks``, and its flat position q is sample j *
    payload - lead + q of row s.  A pass given ``window=`` reads its blocks
    from the signal [S, length] itself, zeros before a row's start; a pass
    given ``cut=`` writes the positions q >= lead of its blocks to the
    output [S, length] itself, and nothing else (``fused_pass``)."""

    payload: int
    lead: int
    length: int

    def __post_init__(self):
        if (self.payload < 1 or self.lead < 0 or self.length < 1
                or self.length % self.payload):
            raise ValueError(f"bad edges {self}: payload >= 1, lead >= 0, "
                             f"length a multiple of payload")

    @property
    def blocks(self) -> int:
        """Payloads, so blocks, per signal row."""
        return self.length // self.payload

    @property
    def n(self) -> int:
        """Samples of one block."""
        return self.payload + self.lead


#: The one form of pass that carries each edge, as the library holds it
#: (``edge_form`` of ``csrc/fused_pass.cuh``): the dtype of its input and
#: output blocks, its direction and the form of its products.  The window
#: is the convolution's int32 forward's first pass, the cut its int64
#: inverse's last.
EDGE_FORMS = {"window": (torch.int32, False, "int32"),
              "cut": (torch.int64, True, "mod64")}


def edge_fault(side: str, edges: Edges, cfg: FFTConfig, cols: int, dtype,
               kw) -> str | None:
    """Why a pass of ``cfg`` over [B, cfg.n, ``cols``] blocks of ``dtype``,
    with ``fused_pass``'s keyword arguments ``kw`` but the tables' values,
    cannot take ``edges`` on ``side`` ("window": its first load, "cut": its
    last store); None where it can.  It must be the form of ``EDGE_FORMS``
    with 1-D stage tables on the padded tile, its side not turned, and the
    lead and the payload whole rows of its blocks."""
    inverse, natural = kw.get("inverse", False), kw.get("natural", True)
    turned_out = kw.get("transpose_out", False)
    out_dtype = kw.get("out_dtype") or dtype
    two_d = kw.get("tables_2d") is not None
    product = product_form(cfg, out_dtype, inverse,
                           kw.get("epi") is not None
                           or kw.get("synth") is not None, two_d)
    if (dtype, inverse, product) != EDGE_FORMS[side] or out_dtype != dtype:
        return (f"the {side} runs on the form {EDGE_FORMS[side]} alone, this "
                f"pass is ({dtype}, {inverse}, {product!r}) -> {out_dtype}")
    if two_d or (not inverse and natural and turned_out
                 and tile_skew(cfg.n, dtype.itemsize)):
        return f"the {side} runs with 1-D tables on the padded tile alone"
    if kw.get("transpose_in" if side == "window" else "transpose_out"):
        return f"the {side}'s side of the pass is turned"
    if cfg.n * cols != edges.n or edges.lead % cols or edges.payload % cols:
        return (f"the lead {edges.lead} and the payload {edges.payload} are "
                f"no whole rows of the pass's [{cfg.n}, {cols}] blocks")
    return None


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


def _check_blocks(x_re, x_im):
    """The re and im blocks of a call: contiguous, of one shape, dtype and
    device."""
    if not (x_re.is_contiguous() and x_im.is_contiguous()):
        raise ValueError("blocks must be contiguous")
    if (x_im.shape != x_re.shape or x_im.dtype != x_re.dtype
            or x_im.device != x_re.device):
        raise ValueError("re and im blocks differ in shape, dtype or device")


def _edge_shapes(shape, cfg: FFTConfig, transpose_in, transpose_out,
                 window: Edges | None, cut: Edges | None):
    """(the blocks a pass on input ``shape`` runs on, the shape of its
    output): ``shape`` and its store's blocks for a plain pass; with
    ``window`` the signal [S, length] as S * blocks blocks of [cfg.n, n /
    cfg.n]; with ``cut`` the output as the signal [B / blocks, length]."""
    if window is not None and cut is not None:
        raise ValueError("a pass takes the window or the cut, not both")
    shape = tuple(shape)
    if window is not None:
        if len(shape) != 2 or shape[1] != window.length or window.n % cfg.n:
            raise ValueError(f"a window of [{cfg.n}, n / {cfg.n}] blocks, "
                             f"n = {window.n}, reads the signal [S, "
                             f"{window.length}], got {shape}")
        shape = (shape[0] * window.blocks, cfg.n, window.n // cfg.n)
    out = _out_shape(shape, cfg, transpose_in, transpose_out)
    if cut is not None:
        if (len(shape) != 3 or shape[0] % cut.blocks
                or shape[1] * shape[2] != cut.n):
            raise ValueError(f"a cut writes whole signal rows of "
                             f"{cut.blocks} blocks of {cut.n}, got {shape}")
        out = (shape[0] // cut.blocks, cut.length)
    return shape, out


def _check_pass(shape, dtype, dev, cfg: FFTConfig, tables, epi, synth,
                tables_2d, natural, transpose_in, out_dtype,
                transpose_out=False, inverse=False,
                window: Edges | None = None, cut: Edges | None = None):
    """What a pass on input ``shape`` and ``dtype`` on ``dev`` takes: the
    factor, the block and table shapes, dtypes and devices, the widths, the
    edges (``edge_fault``).  Returns ``_edge_shapes``: the blocks it runs
    on and its output's shape."""
    shape, out_shape = _edge_shapes(shape, cfg, transpose_in, transpose_out,
                                    window, cut)
    check_width(cfg)
    if not MIN_ROWS <= cfg.n <= MAX_ROWS:
        raise ValueError(f"factor size {cfg.n} outside [{MIN_ROWS}, "
                         f"{MAX_ROWS}]")
    if (tables is None) == (tables_2d is None):
        raise ValueError("give either the stage tables or the 2-D tables")
    if epi is not None and synth is not None:
        raise ValueError("give either an epilogue table or synth")
    axis = 2 if transpose_in else 1
    if (dtype, out_dtype) not in PASS_DTYPES:
        raise TypeError(f"a pass takes (in, out) blocks {PASS_DTYPES}, got "
                        f"({dtype}, {out_dtype})")
    if len(shape) != 3 or shape[axis] != cfg.n:
        want = "[B, C, {}]" if transpose_in else "[B, {}, C]"
        raise ValueError(f"expected {want.format(cfg.n)} blocks, got "
                         f"{tuple(shape)}")
    bits = torch.iinfo(out_dtype).bits
    if cfg.output_width > bits:
        raise ValueError(f"{out_dtype} blocks hold <= {bits} "
                         f"bits, this factor's output is {cfg.output_width}")
    if out_dtype == torch.int64 and (synth is not None
                                     or tables_2d is not None):
        raise ValueError("int64 blocks take neither the in-kernel synthesis "
                         "nor the 2-D stage tables (the JAX package has "
                         "no wide form of either)")
    cols = shape[3 - axis]
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
    for shape_, t in want:
        if (tuple(t.shape) != shape_ or t.dtype != torch.int32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"table must be contiguous int32 {shape_} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for side, edges in (("window", window), ("cut", cut)):
        fault = edges and edge_fault(side, edges, cfg, cols, dtype, dict(
            inverse=inverse, natural=natural, transpose_in=transpose_in,
            transpose_out=transpose_out, out_dtype=out_dtype, epi=epi,
            synth=synth, tables_2d=tables_2d))
        if fault:
            raise ValueError(fault)
    return shape, out_shape


#: The forms of a pass's complex products (``product_form``).
PRODUCT_FORMS = ("int32", "mod32", "mod64", "limb64", "int128")


def product_form(cfg: FFTConfig, out_dtype: torch.dtype, inverse: bool,
                 epilogue: bool, two_d: bool = False) -> str:
    """The form a pass forms its complex product-sums in.  On the int32
    tile: ``"mod32"`` where every product keeps bits that fit in 32, else
    ``"int32"`` (exact in 64 bits); on the int64 tile (``out_dtype``
    int64): ``"mod64"`` where they fit in 64, else ``"limb64"`` (exact, in
    two 32-bit limbs a datum; ``"int128"`` is the whole form's).  A
    product is floor-shifted by ``cfg.twiddle_shift`` and wrapped to w
    bits, so it keeps its bits twiddle_shift .. twiddle_shift + w - 1, the
    same modulo the word where they fit.  Stage j enters at ``data_width +
    j * (1 - scale)`` bits and multiplies where its twiddle order is at
    least 2 (order j inverse, log2(n) - 1 - j forward), or at every order
    with the 2-D stage tables (``two_d``), wrapped to its input width
    inverse (DIT) and its output width forward (DIF); the ``epilogue``
    wraps to the factor's output width.  ``intfft_prepare_pass`` holds the
    C entry's request to the same rule (``product_fits``) and refuses a
    modular one that breaks it."""
    bits = 64 if out_dtype == torch.int64 else 32
    stages = cfg.n.bit_length() - 1
    gain = 1 - cfg.scale
    widths = []
    if not cfg.bypass_fly:
        for j in range(stages):
            order = j if inverse else stages - 1 - j
            if order >= 2 or two_d:
                widths.append(cfg.data_width + (j if inverse else j + 1)
                              * gain)
    if epilogue:
        widths.append(cfg.data_width + stages * gain)
    fits = max(widths, default=0) + cfg.twiddle_shift <= bits
    if bits == 32:
        return "mod32" if fits else "int32"
    return "mod64" if fits else "limb64"


def modular(form: str) -> bool:
    """Whether ``form`` (of ``PRODUCT_FORMS``) forms its product-sums modulo
    the tile's word: the C entries' product flag."""
    return form in ("mod32", "mod64")


def _pass_ints(cfg: FFTConfig, shape, in_dtype, out_dtype, synth, inverse,
               natural, transpose_in, transpose_out, lane_tile, threads,
               product, window: Edges | None = None,
               cut: Edges | None = None):
    """The integers of a pass on blocks of ``shape``, as the C entries take
    them: batch, rows, cols, the element sizes, the numerics, the layout,
    the synthesis constants, TC, threads per CTA, the product form
    (``product_form``: 1 for a ``modular`` one, else 0) and the edge: its
    kind (1 the window, 2 the cut), blocks per signal row, payload and
    lead (zeros for none)."""
    r = cfg.n
    c = shape[1] if transpose_in else shape[2]
    prm = synth_params(cfg, synth.n) if synth is not None else (0, 0, 0, 0)
    edges = window or cut
    edge = ((1 if window else 2, edges.blocks, edges.payload, edges.lead)
            if edges else (0, 0, 0, 0))
    return (shape[0], r, c, in_dtype.itemsize, out_dtype.itemsize,
            cfg.data_width, cfg.scale, int(cfg.rounding == "round"),
            cfg.twiddle_shift, int(cfg.bypass_fly), int(inverse),
            int(natural), int(transpose_in), int(transpose_out), *prm,
            lane_tile, threads, int(modular(product)), *edge)


def _table_ptrs(tables, tables_2d, epi, synth) -> tuple:
    """The device pointers of a pass's tables, in the C entries' order
    (w, t2, e, c; re then im), None where a pass takes none."""
    pair = lambda p: ((p[0].data_ptr(), p[1].data_ptr()) if p is not None
                      else (None, None))
    return (*pair(tables), *pair(tables_2d), *pair(epi),
            *pair(synth[:2] if synth is not None else None))


def _out_shape(shape, cfg: FFTConfig, transpose_in, transpose_out):
    c = shape[1] if transpose_in else shape[2]
    return (shape[0], c, cfg.n) if transpose_out else (shape[0], cfg.n, c)


def _edge_positions(edges: Edges):
    """[blocks, n]: each block's flat positions as samples of its signal
    row, j * payload - lead + q (negative before the row's start)."""
    j = torch.arange(edges.blocks)[:, None]
    return j * edges.payload - edges.lead + torch.arange(edges.n)[None, :]


def window_reference(x, edges: Edges, rows: int):
    """The blocks [S * blocks, rows, n / rows] that a pass given
    ``window=edges`` reads from the signal ``x`` [S, length]: block (s, j)
    holds sample j * payload - lead + q of row s at flat position q, zero
    where that is negative (the kernel's offsets and predicate)."""
    at = _edge_positions(edges).to(x.device)
    blocks = torch.where(at >= 0, x[:, at.clamp(min=0)], 0)
    return blocks.reshape(-1, rows, edges.n // rows).to(x.dtype)


def cut_reference(y, edges: Edges):
    """The output [B / blocks, length] that a pass given ``cut=edges``
    writes from its blocks ``y`` [B, R, C]: flat position q >= lead of
    block (s, j) to sample j * payload - lead + q of row s (the kernel's
    offsets and predicate), every sample written once."""
    keep = torch.arange(edges.n, device=y.device) >= edges.lead
    at = _edge_positions(edges).to(y.device)[:, keep].reshape(-1)
    y = y.reshape(-1, edges.blocks, edges.n)[:, :, keep]
    out = torch.empty((y.shape[0], edges.length), dtype=y.dtype,
                      device=y.device)
    out[:, at] = y.reshape(y.shape[0], -1)
    return out


def fused_pass_reference(x_re, x_im, cfg: FFTConfig, tables, *, epi=None,
                         synth: EpiSynth | None = None, tables_2d=None,
                         transpose_out: bool, inverse: bool = False,
                         natural: bool = True, transpose_in: bool = False,
                         out_dtype: torch.dtype | None = None,
                         lane_tile: int | None = None,
                         threads: int | None = None,
                         window: Edges | None = None,
                         cut: Edges | None = None):
    """Plain PyTorch version of ``fused_pass`` (any device): the eager
    stages of ``transform.fft_stages`` (or ``fft_stages_2d``) on the
    [B, C, R] view, the epilogue (``synth``: its table from
    ``synth_circle_block``) through ``intmath.cmult_exact``, then the store
    layout and dtype; the blocks read through ``window_reference`` and
    written through ``cut_reference`` where the pass takes an edge.
    ``lane_tile`` and ``threads`` are taken and ignored: the plain version
    has no launch geometry."""
    if window is not None:
        x_re, x_im = (window_reference(x, window, cfg.n)
                      for x in (x_re, x_im))
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
    yr, yi = yr.to(dt).contiguous(), yi.to(dt).contiguous()
    if cut is not None:
        yr, yi = cut_reference(yr, cut), cut_reference(yi, cut)
    return yr, yi


def fused_pass(x_re, x_im, cfg: FFTConfig, tables, *, epi=None,
               synth: EpiSynth | None = None, tables_2d=None,
               transpose_out: bool, inverse: bool = False,
               natural: bool = True, transpose_in: bool = False,
               out_dtype: torch.dtype | None = None,
               lane_tile: int | None = None, threads: int | None = None,
               window: Edges | None = None, cut: Edges | None = None):
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

    The convolution's edges (``Edges``; one of the two, on the one form
    of pass that carries it, ``EDGE_FORMS``, else ValueError): with
    ``window`` the input is the signal [S, length] and the pass reads its
    S * blocks blocks from it in place; with ``cut`` the output is the
    convolution's [B / blocks, length], written in place from the blocks'
    positions past the lead (``window_reference``, ``cut_reference``).

    ``lane_tile``: TC, the columns of a block one CTA holds, a power of
    two; ``threads``: threads per CTA.  The plans resolve both once, at
    build (``tuning.pass_geometry``); a caller that leaves them out gets
    the device's row, resolved on this call.  The C entry refuses a TC
    that is no power of two or whose tile exceeds the card's shared memory
    per CTA, and a thread count the library was not built for
    (RuntimeError); it clamps nothing.

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation) and adds the launches made to ``fused_pass.launches``:
    one, or one for every 65 535 blocks or part of them (a grid holds no
    more), and leaves what it launched in ``fused_pass.geometry`` (TC,
    threads per CTA, shared memory per CTA in bytes, CTAs along the
    columns, as the C entry reports them); a CPU tensor runs
    ``fused_pass_reference``."""
    out_dtype = out_dtype or x_re.dtype
    dev = x_re.device
    _check_blocks(x_re, x_im)
    shape, oshape = _check_pass(x_re.shape, x_re.dtype, dev, cfg, tables,
                                epi, synth, tables_2d, natural, transpose_in,
                                out_dtype, transpose_out, inverse, window,
                                cut)
    if not use_kernel(dev):
        return fused_pass_reference(x_re, x_im, cfg, tables, epi=epi,
                                    synth=synth, tables_2d=tables_2d,
                                    transpose_out=transpose_out,
                                    inverse=inverse, natural=natural,
                                    transpose_in=transpose_in,
                                    out_dtype=out_dtype, window=window,
                                    cut=cut)
    lane_tile, threads = _geometry(dev, cfg, shape, transpose_in,
                                   out_dtype, lane_tile, threads)
    y_re = torch.empty(oshape, dtype=out_dtype, device=dev)
    y_im = torch.empty(oshape, dtype=out_dtype, device=dev)
    lib = _build.library(threads)
    out = _REPORT()
    product = product_form(cfg, out_dtype, inverse,
                           epi is not None or synth is not None,
                           tables_2d is not None)
    err = lib.intfft_fused_pass(
        x_re.data_ptr(), x_im.data_ptr(), y_re.data_ptr(), y_im.data_ptr(),
        *_table_ptrs(tables, tables_2d, epi, synth),
        *_pass_ints(cfg, shape, x_re.dtype, out_dtype, synth, inverse,
                    natural, transpose_in, transpose_out, lane_tile,
                    threads, product, window, cut),
        dev.index, stream_handle(dev), out)
    if err:
        _build.check(lib, err, f"fused_pass launch (TC {lane_tile}, "
                     f"{threads} threads per CTA)")
    fused_pass.launches += out[0]
    fused_pass.geometry = tuple(out[1:5])
    return y_re, y_im


def _geometry(dev, cfg: FFTConfig, shape, transpose_in, out_dtype,
              lane_tile, threads):
    """(TC, threads per CTA) of a pass: the caller's, else the device
    row's."""
    if lane_tile is None or threads is None:
        c = shape[1] if transpose_in else shape[2]
        g = _device_geometry(dev, cfg.n, c, out_dtype == torch.int64)
        lane_tile = g["lane_tile"] if lane_tile is None else lane_tile
        threads = g["threads"] if threads is None else threads
    return lane_tile, threads


@functools.lru_cache(maxsize=256)
def _device_geometry(dev: torch.device, rows: int, cols: int, wide: bool):
    """The launch geometry the row of ``dev`` gives a pass (a read-only
    dict), worked out once per device and shape."""
    return pass_geometry(device_tuning(dev), rows, cols, wide)


#: Kernel launches made by ``fused_pass`` and by the prepared chains
#: (``PreparedChain``): a plain count; reset it to 0.
fused_pass.launches = 0
#: (TC, threads per CTA, shared memory per CTA in bytes, CTAs along the
#: columns) of the last pass launched, as the C entry reported it.
fused_pass.geometry = None


class PreparedPass:
    """One ``fused_pass`` resolved once for blocks of one shape and dtype on
    one CUDA device: its arguments checked (``fused_pass``'s checks), its
    launch geometry resolved, and the C prepare step run
    (``intfft_prepare_pass``: the library's checks, the kernel of its form
    and thread count, the shared-memory grant), which fills ``desc``.
    ``PreparedChain`` launches it; it keeps the tables it reads alive.
    ``geometry`` is what the C entry reported (TC, threads per CTA, shared
    memory per CTA in bytes, CTAs along the columns); ``out_shape`` and
    ``out_dtype`` are its output's; ``product`` the form of its complex
    products (``product_form``), whose kernel the C entry took; ``skew``
    the skew of its tile as the C entry chose it (``tuning.tile_skew``
    where the forward stores turned in natural order with 1-D stage
    tables, else 0).  With ``window`` ``shape`` is the signal's, with
    ``cut`` ``out_shape`` the output's (``fused_pass``).  Raises ValueError
    on a CPU device: the plain version needs no preparing."""

    def __init__(self, shape, dtype, dev, cfg: FFTConfig, tables, *,
                 epi=None, synth: EpiSynth | None = None, tables_2d=None,
                 transpose_out: bool, inverse: bool = False,
                 natural: bool = True, transpose_in: bool = False,
                 out_dtype: torch.dtype | None = None,
                 lane_tile: int | None = None, threads: int | None = None,
                 window: Edges | None = None, cut: Edges | None = None):
        out_dtype = out_dtype or dtype
        shape, self.out_shape = _check_pass(
            shape, dtype, dev, cfg, tables, epi, synth, tables_2d, natural,
            transpose_in, out_dtype, transpose_out, inverse, window, cut)
        if not use_kernel(dev):
            raise ValueError(f"a prepared pass launches the kernel; {dev} "
                             f"runs the plain version (fused_pass)")
        lane_tile, threads = _geometry(dev, cfg, shape, transpose_in,
                                       out_dtype, lane_tile, threads)
        self.lib = _build.library(threads)
        self.out_dtype = out_dtype
        self.product = product_form(cfg, out_dtype, inverse,
                                    epi is not None or synth is not None,
                                    tables_2d is not None)
        self.keep = [t for pair in (tables, tables_2d, epi, synth)
                     if pair is not None for t in pair[:2]]
        self.table_ptrs = _table_ptrs(tables, tables_2d, epi, synth)
        size = self.lib.intfft_prepared_size()
        self.desc = (ctypes.c_uint64 * (size // 8))()
        report = (ctypes.c_int * 5)()
        mask = sum(bit for bit, pair in ((1, tables), (2, tables_2d),
                                         (4, epi), (8, synth))
                   if pair is not None)
        err = self.lib.intfft_prepare_pass(
            *_pass_ints(cfg, shape, dtype, out_dtype, synth, inverse,
                        natural, transpose_in, transpose_out, lane_tile,
                        threads, self.product, window, cut), mask,
            dev.index, self.desc, report)
        if err:
            _build.check(self.lib, err, f"fused_pass prepare (TC "
                         f"{lane_tile}, {threads} threads per CTA)")
        self.geometry = tuple(report[:4])
        self.skew = report[4]


class PreparedChain:
    """Passes prepared once for one input (shape, dtype, CUDA device) and
    launched in order by one C call per call (``intfft_fused_chain``), where
    ``fused_pass`` checks, resolves and launches one pass per call.

    ``passes``: (cfg, keyword arguments of ``fused_pass``) in launch order,
    as ``LargeFFTPlan.passes()`` gives them; pass i reads pass i - 1's
    output.  With ``whole`` (the keyword arguments of ``fused_whole`` but
    the passes: ``batch_block``, ``cluster``) the two passes
    are one ``PreparedWhole``, one launch of the cluster kernel, counted in
    ``fused_whole.launches``.  A call takes contiguous re and im blocks of
    the prepared shape, dtype and device (else ValueError; nothing else is
    checked again), allocates each pass's re and im output as two fresh
    tensors (as ``fused_pass`` does: the two halves of one allocation, a
    power of two bytes apart, made the card slower on the config-2 chain,
    ``tools/ab_torch_paths.py``), launches every pass on the current
    stream (no synchronisation), adds the launches made to
    ``fused_pass.launches`` (``fused_whole.launches``), leaves the last
    pass's geometry in ``fused_pass.geometry`` (``fused_whole.geometry``)
    and returns the last pass's output.  The bits are ``fused_pass``'s, pass by pass.
    Passes of one thread-count library go out in one C call; a sweep's
    variant (``_build.library(threads)``) is a library of its own, so a
    chain that mixes it with the tuning rows' counts takes one C call per
    run of passes in one library.  ``products``: the form of each pass's
    complex products in launch order (``product_form``; both factors' of a
    whole call), which ``products_note`` counts, beside ``skewed``: how
    many of its passes run on the skewed tile (``PreparedPass.skew``; the
    whole form's none).  Where pass 1 reads a window, a call takes the
    signal; where the last pass writes a cut, it returns the output."""

    def __init__(self, shape, dtype, dev, passes, whole=None):
        self.in_shape, self.in_dtype, self.device = tuple(shape), dtype, dev
        self.counter = fused_pass if whole is None else fused_whole
        if whole is not None:
            self.passes = [PreparedWhole(shape, dtype, dev, passes, **whole)]
        else:
            self.passes = []
            for cfg, kw in passes:
                p = PreparedPass(shape, dtype, dev, cfg, **kw)
                self.passes.append(p)
                shape, dtype = p.out_shape, p.out_dtype
        self.products = (self.passes[0].products if whole is not None
                         else tuple(p.product for p in self.passes))
        self.skewed = sum(getattr(p, "skew", 0) > 0 for p in self.passes)
        # the runs of passes in one library: (library, its first pass,
        # their descriptors side by side, their 12 pointers each, count)
        self.runs = []
        size = ctypes.sizeof(self.passes[0].desc)
        for lib, run in itertools.groupby(enumerate(self.passes),
                                          key=lambda e: e[1].lib):
            run = list(run)
            descs = (ctypes.c_uint64 * (size // 8 * len(run)))()
            ptrs = (ctypes.c_void_p * (12 * len(run)))()
            for k, (_, p) in enumerate(run):
                ctypes.memmove(ctypes.addressof(descs) + k * size, p.desc,
                               size)
                ptrs[12 * k + 2:12 * k + 10] = p.table_ptrs
            self.runs.append((lib, run[0][0], descs, ptrs, len(run)))
        self.geometry = self.passes[-1].geometry
        self._report = (ctypes.c_int * 1)()
        # the pointer arrays are filled in and read by the C call, which
        # runs without the interpreter lock: one call at a time
        self._lock = threading.Lock()

    def __call__(self, x_re, x_im):
        if (x_re.shape != self.in_shape or x_re.dtype != self.in_dtype
                or x_re.device != self.device):
            raise ValueError(
                f"this chain was prepared for {self.in_dtype} "
                f"{self.in_shape} blocks on {self.device}, got "
                f"{x_re.dtype} {tuple(x_re.shape)} on {x_re.device}")
        _check_blocks(x_re, x_im)
        dev = self.device
        outs = [tuple(torch.empty(p.out_shape, dtype=p.out_dtype, device=dev)
                      for _ in range(2)) for p in self.passes]
        stream = stream_handle(dev)
        launches = 0
        try:
            with self._lock:
                x = (x_re.data_ptr(), x_im.data_ptr())
                for lib, first, descs, ptrs, n in self.runs:
                    for k in range(n):
                        y = outs[first + k]
                        ptrs[12 * k], ptrs[12 * k + 1] = x
                        x = (y[0].data_ptr(), y[1].data_ptr())
                        ptrs[12 * k + 10], ptrs[12 * k + 11] = x
                    err = lib.intfft_fused_chain(descs, n, ptrs, dev.index,
                                                 stream, self._report)
                    launches += self._report[0]
                    if err:
                        _build.check(lib, err, "fused_pass chain launch")
        finally:
            self.counter.launches += launches
        self.counter.geometry = self.geometry
        return outs[-1]


def products_note(products, skewed: int = 0, epi: str | None = None) -> str:
    """What a ``plan.prepare`` span notes of a chain whose passes form
    their complex products as ``products`` and of which ``skewed`` run on
    the skewed tile: each form of ``PRODUCT_FORMS`` and how many passes
    take it, then "skew" and that count, e.g. "product int32 0 mod32 2
    mod64 0 limb64 0 int128 0 skew 1", then ``epi`` where the chain has
    an inter-factor twiddle (``LargeFFTPlan.epi_note``): "... skew 1 epi
    device 524288" (the core's 64k chain)."""
    return ("product " + " ".join(f"{f} {list(products).count(f)}"
                                  for f in PRODUCT_FORMS)
            + f" skew {skewed}" + (f" {epi}" if epi else ""))


def epi_table_bytes(mode: str, n1: int, n2: int) -> int:
    """The bytes of table that each call's pass 1 reads for a four-step
    plan's inter-factor twiddle from ``mode`` (``LargeFFTPlan.epi_mode``):
    the [n1, n2] table's two int32 planes from ``"host"`` or ``"device"``,
    the coarse table's ``COARSE_BYTES`` ``"inkernel"``."""
    return COARSE_BYTES if mode == "inkernel" else TABLE_ENTRY_BYTES * n1 * n2


def fused_four_step_reference(x_re, x_im, passes):
    """Plain PyTorch version of ``fused_whole`` (any device): the two passes
    ``passes`` ((cfg, keyword arguments of ``fused_pass``), as
    ``LargeFFTPlan.passes()`` gives them: pass 1 with its epilogue and
    turned store, then pass 2) by ``fused_pass_reference`` in turn, so its
    bits are the split form's by construction."""
    for cfg, kw in passes:
        x_re, x_im = fused_pass_reference(x_re, x_im, cfg, **kw)
    return x_re, x_im


def _whole_form(shape, dtype, dev, passes):
    """Check that ``passes`` are what ``fused_whole`` runs in one launch on
    blocks of ``shape`` and ``dtype`` on ``dev``, and return their C form:
    (the integers of ``intfft_prepare_whole`` from the batch to the order,
    the table mask, the tables (w1, t2, e, w2; None where absent), the
    output's dtype)."""
    if len(passes) != 2:
        raise ValueError(f"the whole form runs two passes, got {len(passes)}")
    (cfg1, kw1), (cfg2, kw2) = passes
    kw1, kw2 = dict(kw1), dict(kw2)
    for kw in (kw1, kw2):
        kw.pop("lane_tile", None), kw.pop("threads", None)
        kw.setdefault("tables", None)
    mid, out = kw1.get("out_dtype", dtype), kw2.get("out_dtype", dtype)
    if (dtype, mid, out) not in WHOLE_DTYPES:
        raise TypeError(f"the whole form takes int16 or int32 blocks "
                        f"throughout, or a wide chain (in, pass 1's out, "
                        f"out) of {WHOLE_DTYPES[2:]}; got ({dtype}, {mid}, "
                        f"{out})")
    inverse = kw1.get("inverse", False)
    natural = kw1.get("natural", True)
    two_d = kw1.get("tables_2d"), kw2.get("tables_2d")
    if (not kw1.get("transpose_out") or kw2.get("transpose_out")
            or kw1.get("transpose_in") or kw2.get("transpose_in")
            or kw1.get("synth") is not None or kw2.get("epi") is not None
            or (kw2.get("inverse", False), kw2.get("natural", True))
            != (inverse, natural)
            or two_d[not inverse] is not None
            or (two_d[inverse] is not None and kw1.get("epi") is not None)
            or (any(t is not None for t in two_d) and out == torch.int64)):
        raise ValueError(
            "the whole form runs pass 1 (epilogue from a table, turned store) "
            "then pass 2 of one direction and order: LargeFFTPlan.passes() of "
            "a four-step plan, or of a monolithic plan of <= 32 bits")
    for cfg, kw, shp, dt, dt_out in (
            (cfg1, kw1, shape, dtype, mid),
            (cfg2, kw2, _out_shape(shape, cfg1, False, True), mid, out)):
        _check_pass(shp, dt, dev, cfg, kw["tables"], kw.get("epi"), None,
                    kw.get("tables_2d"), natural, False, dt_out)
    if cfg2.n != shape[2] or (cfg1.mode, cfg1.rounding, cfg1.twiddle_shift,
                              cfg1.bypass_fly) != (
            cfg2.mode, cfg2.rounding, cfg2.twiddle_shift, cfg2.bypass_fly):
        raise ValueError("the two factors of a whole call differ in more "
                         "than their size and input width")
    tables = (kw1["tables"], two_d[0] if two_d[0] is not None else two_d[1],
              kw1.get("epi"), kw2["tables"])
    mask = sum(bit for bit, t in zip((1, 2, 4, 8), tables) if t is not None)
    ints = (shape[0], cfg1.n, cfg2.n, dtype.itemsize, mid.itemsize,
            out.itemsize, cfg1.data_width, cfg2.data_width, cfg1.scale,
            int(cfg1.rounding == "round"), cfg1.twiddle_shift,
            int(cfg1.bypass_fly), int(inverse), int(natural))
    return ints, mask, tables, out


def whole_batch_block(batch: int, batch_block: int) -> int:
    """The items one cluster of the whole kernel runs in turn:
    ``batch_block`` reduced to a divisor of ``batch`` (``while nb % bk: bk
    -= 1``, as ``pallas_fft.py:1320-1321``)."""
    bk = batch_block
    while batch % bk:
        bk -= 1
    return bk


class PreparedWhole:
    """One ``fused_whole`` call resolved once for blocks of one shape and
    dtype on one CUDA device, as ``PreparedPass`` is for a pass: the passes
    checked, ``batch_block`` reduced to a divisor of the batch
    (``whole_batch_block``), the launch geometry chosen, and the C prepare
    step run (``intfft_prepare_whole``: the library's checks, the kernel of
    its form and shape, the shared-memory grant, and a refusal of a grid the
    card cannot schedule), which fills ``desc``.

    The geometry: every candidate of ``tuning.whole_candidates`` (only
    ``cluster`` where it is given) is read on the card
    (``intfft_query_whole``: the clusters it holds at once), and
    ``tuning.whole_launch`` takes the batch and those counts and chooses
    the cluster, the shape and the clusters of the persistent grid; a form
    the card holds no cluster of raises RuntimeError, and nothing runs in
    its place.  ``held`` maps each candidate to its count; ``geometry`` is
    what the C entry reported: the cluster size, threads per CTA, shared
    memory per CTA in bytes, clusters of the launch, clusters the card holds
    at once, CTAs per SM, registers and local bytes per thread, and the
    rounds (the blocks the busiest cluster runs).  ``products``: the form
    of each factor's complex products (``PRODUCT_FORMS``), always exact."""

    def __init__(self, shape, dtype, dev, passes, *, batch_block: int = 2,
                 cluster: int | None = None):
        ints, mask, tables, out_dtype = _whole_form(shape, dtype, dev, passes)
        if not use_kernel(dev):
            raise ValueError(f"a prepared whole call launches the kernel; "
                             f"{dev} runs the plain version (fused_whole)")
        if batch_block < 1:
            raise ValueError(f"batch_block {batch_block} must be >= 1")
        bk = whole_batch_block(shape[0], batch_block)
        sizes = ints[4], ints[5]
        cands = whole_candidates(device_tuning(dev), shape[1], shape[2],
                                 *sizes, cluster)
        if not cands:
            raise ValueError(f"[{shape[1]}, {shape[2]}] {dtype} items do not "
                             f"fit a cluster of "
                             f"{cluster or f'at most {MAX_CLUSTER}'} CTAs "
                             f"of the whole kernel")
        self.lib = _build.library()
        wide = sizes[1] == 8
        mono = int(mask & 2 != 0)
        self.held = {}
        for c, threads, ctas in cands:
            out = (ctypes.c_int * 5)()
            err = self.lib.intfft_query_whole(
                shape[1], shape[2], *ints[3:6], mono, ints[12], c,
                *whole_shape(threads, ctas, wide), dev.index, out)
            if err:
                _build.check(self.lib, err, f"fused_whole query (cluster of "
                             f"{c}, {threads} threads per CTA)")
            self.held[(c, threads, ctas)] = out[3]
        launch = whole_launch(shape[0], bk, self.held)
        if launch is None:
            raise RuntimeError(f"the card holds no cluster of the whole "
                               f"kernel for [{shape[1]}, {shape[2]}] {dtype} "
                               f"items (clusters held: {self.held})")
        self.out_shape = (shape[0], shape[2], shape[1])
        self.out_dtype = out_dtype
        # the cluster kernel forms every product exactly: in 64 bits on an
        # int32 factor, in __int128 on an int64 one
        self.products = tuple(
            "int128" if kw.get("out_dtype", dtype) == torch.int64
            else "int32" for _, kw in passes)
        self.keep = [t for pair in tables if pair is not None for t in pair]
        pair = lambda p: ((p[0].data_ptr(), p[1].data_ptr()) if p is not None
                          else (None, None))
        self.table_ptrs = tuple(v for p in tables for v in pair(p))
        size = self.lib.intfft_prepared_size()
        self.desc = (ctypes.c_uint64 * (size // 8))()
        report = (ctypes.c_int * 9)()
        err = self.lib.intfft_prepare_whole(
            *ints, launch["cluster"],
            *whole_shape(launch["threads"], launch["ctas_per_sm"], wide),
            launch["clusters"], bk, mask, dev.index, self.desc, report)
        if err:
            _build.check(self.lib, err, f"fused_whole prepare ({launch}, "
                         f"batch_block {bk})")
        self.batch_block = bk
        self.launch = launch
        self.geometry = tuple(report)


def fused_whole(x_re, x_im, passes, *, batch_block: int = 2,
                cluster: int | None = None):
    """The two passes ``passes`` (as ``LargeFFTPlan.passes()`` gives them for
    a four-step plan, or a monolithic plan of <= 32-bit data: pass 1 with
    its epilogue table and turned store, pass 2 on its output) in one
    launch: [B, R1, C1] blocks -> [B, C1, R1], bit-equal to the two
    ``fused_pass`` launches.  The block dtypes (in, pass 1's out, out) are
    one of ``WHOLE_DTYPES``: int16 or int32 throughout, or a wide chain
    to int64 (outputs of up to 64 bits; four-step only).

    ``cluster``: the CTAs one item takes (1, 2, 4, 8 or 16; by default
    the one ``tuning.whole_launch`` chooses for this batch from the
    clusters the card holds); ``batch_block``: the consecutive items one
    cluster runs in turn as a block, reduced to a divisor of the batch.
    The grid is persistent: at most as many clusters as the card holds at
    once, each running the blocks g, g + G, ... of the batch, so
    ``batch_block`` sets how the items are dealt, not how many clusters
    run (``PreparedWhole``).  A CUDA tensor
    launches the cluster kernel on the current stream (no
    synchronisation), adds 1 to ``fused_whole.launches`` and
    leaves the C entry's report in ``fused_whole.geometry``
    (``PreparedWhole``); the C entry refuses what it cannot launch
    (RuntimeError with the CUDA error), and nothing runs in its place.  A
    CPU tensor runs ``fused_four_step_reference``."""
    _check_blocks(x_re, x_im)
    dev = x_re.device
    if not use_kernel(dev):
        _whole_form(x_re.shape, x_re.dtype, dev, passes)
        return fused_four_step_reference(x_re, x_im, passes)
    return PreparedChain(x_re.shape, x_re.dtype, dev, passes, whole=dict(
        batch_block=batch_block, cluster=cluster))(x_re, x_im)


#: Launches of the whole kernel made by ``fused_whole`` and by the prepared
#: chains of whole-form plans: a plain count; reset it to 0.
fused_whole.launches = 0
#: The C entry's report of the last whole launch (``PreparedWhole``).
fused_whole.geometry = None


class PreparedPlan(nn.Module):
    """What the modules whose calls on the card go through prepared
    launches share: one prepared object (a ``PreparedChain``, or P1's
    ``PreparedProduct``) per key of input shape, dtype, device and form,
    made at the first call with that key, and the ``CapturedCall``s made
    from the module or from a module holding it (``capture()``), all
    dropped when the launch geometry or a buffer changes (``retune``,
    ``.to()``: ``invalidate``).  ``epi_note``: what a chain's
    ``plan.prepare`` note ends with, where the module's chain has an
    inter-factor twiddle (``LargeFFTPlan.epi_note``), else None."""

    epi_note = None

    def __init__(self):
        super().__init__()
        self._prepared = {}
        self._captures = weakref.WeakSet()

    def _prepare(self, key, make):
        """The object prepared for ``key``, made by ``make()`` at its first
        use; while a recording is open its ``plan.prepare`` span notes the
        product forms of a chain's passes, how many run on the skewed tile
        and the source of its inter-factor twiddle (``products_note``), or
        the form of a ``PreparedProduct``'s product-sums ("p1 int128")."""
        obj = self._prepared.get(key)
        if obj is None:
            with trace.span("plan.prepare") as span:
                obj = self._prepared[key] = make()
                if span is not None and hasattr(obj, "products"):
                    span.note = products_note(obj.products, obj.skewed,
                                              self.epi_note)
                elif span is not None and hasattr(obj, "form"):
                    span.note = f"p1 {obj.form}"
        return obj

    def _track(self, call):
        """Register ``call`` (a ``CapturedCall`` that runs this module) to
        be reset with the prepared launches of this module and of every
        ``PreparedPlan`` inside it; returns it."""
        for module in self.modules():
            if isinstance(module, PreparedPlan):
                module._captures.add(call)
        return call

    def invalidate(self):
        """Drop the prepared launches and the graphs of every
        ``CapturedCall`` that runs this module: the next call prepares, and
        captures, again."""
        self._prepared.clear()
        for call in list(self._captures):
            call.reset()

    def _apply(self, *args, **kwargs):
        # .to(), .cuda() and the like replace the buffers the prepared
        # launches read by address
        self.invalidate()
        return super()._apply(*args, **kwargs)


class LargeFFTPlan(PreparedPlan):
    """Large-n FFT on one device: two ``fused_pass`` launches, or one
    ``fused_whole`` launch (``fuse``).

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

    While a recording is open, the table's making is a span
    ``twiddle.table`` noting its source, shape and bytes ("host 256x256
    524288"; "inkernel 512 4096" for the coarse table), and the
    ``plan.build`` span and each chain's ``plan.prepare`` span note
    ``epi_note``: "epi <mode> <bytes>", the bytes of table each call's
    pass 1 reads (``epi_table_bytes``).

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

    ``fuse`` (``pallas_fft.py:1577-1589``): ``"split"`` runs the two passes
    as two launches; ``"whole"`` runs both in one launch of the cluster
    kernel (``fused_whole``: C CTAs per item, the corner turn through
    distributed shared memory, a persistent grid of at most the clusters
    the card holds, each running blocks of ``batch_block`` consecutive
    items, ``batch_block`` reduced to a divisor of the batch; the cluster,
    the CTA's shape and the grid chosen per batch by
    ``tuning.whole_launch``; the split ignores ``batch_block``).
    Its bits are the split's, on data paths up to 64-bit outputs: a wide
    plan's whole form runs its int64 sides on the int64 tile in the one
    launch, one CTA of 256 threads per SM, at clusters of up to 16 CTAs (a
    64k item whose pass 1 stores int64, wide1 or wide_in, takes 16).
    ``"whole"`` raises ValueError with ``epi_synth="inkernel"`` (the whole
    form reads its epilogue from a table, as the JAX one does,
    ``:1599-1600``) and ValueError above the cluster's capacity (it names
    the largest n).  ``"auto"`` takes ``"whole"`` on a narrow plan (<= 32
    bits throughout) where the form is possible and n <= the row's
    ``whole_max_n`` (0 on the rows but the H100's measured one); a wide
    plan splits under ``"auto"`` whatever the row says.
    ``fused_whole`` is the form taken; ``whole_geometry`` its launch,
    read-only (``batch_block``, and ``cluster`` None: the rule's), None for
    the split.

    ``plan.tuning`` is the device's row (``ops/tuning.py``), resolved at
    build (``pallas_fft.py:1578``); ``lane_tile`` overrides its TC on both
    tiles, as the JAX plan's does (``:1512``), within the row's shared
    memory budget; ``pass_geometry`` holds what each pass launches with
    (its ``lane_tile`` and ``threads``; ``retune``).
    """

    @trace.spanned("plan.build")
    def __init__(self, cfg: FFTConfig, n1: int | None = None,
                 n2: int | None = None, inverse: bool = False, *,
                 order: str = "natural", schedule: str = "fourstep",
                 epi_synth: str = "auto", fuse: str = "auto",
                 batch_block: int = 2,
                 device: torch.device | str | None = None,
                 lane_tile: int | None = None):
        super().__init__()
        device = resolve(device)
        self.lane_tile = lane_tile
        if order not in ("natural", "raw"):
            raise ValueError(f"bad order {order!r}")
        if schedule not in ("fourstep", "monolithic"):
            raise ValueError(f"bad schedule {schedule!r}")
        if fuse not in FUSE_MODES:
            raise ValueError(f"bad fuse {fuse!r}")
        if not isinstance(batch_block, int) or batch_block < 1:
            raise ValueError(f"batch_block {batch_block!r} must be an int "
                             f">= 1")
        self.fuse, self.batch_block = fuse, batch_block
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
            table = epi_table_bytes(mode, n1, n2)
            self.epi_note = f"epi {mode} {table}"
            tables["w1r"], tables["w1i"] = pack_tables(self.cfg1)
            tables["w2r"], tables["w2i"] = pack_tables(self.cfg2)
            if mode == "device":
                tables["er"], tables["ei"] = device_circle_table(
                    cfg, n, n1, n2, inverse, device)
            else:
                with trace.span("twiddle.table") as span:
                    if mode == "host":
                        tables["er"], tables["ei"] = circle_table(
                            cfg, n1, n2, inverse, order)
                        shape = f"{n1}x{n2}"
                    else:
                        tables["coarse_re"], tables["coarse_im"] = \
                            coarse_table(cfg)
                        shape = f"{1 << TAYLOR_COARSE_BITS}"
                    if span is not None:
                        span.note = f"{mode} {shape} {table}"
        self.io16 = max(cfg.data_width, self.cfg1.output_width,
                        self.cfg2.output_width) <= 16
        self.wide_in = cfg.data_width > 32
        self.wide1 = self.cfg1.output_width > 32
        self.wide2 = self.cfg2.output_width > 32
        self.in_dtype = block_dtype(cfg.data_width, self.io16)
        self.mid_dtype = block_dtype(self.cfg1.output_width, self.io16)
        self.out_dtype = block_dtype(self.cfg2.output_width, self.io16)
        if fuse == "whole" and self.epi_mode == "inkernel":
            raise ValueError("fuse='whole' reads the inter-factor twiddle "
                             "from a table (epi_synth 'host' or 'device'), "
                             "as the JAX whole kernel does")
        self.retune(device_tuning(device))
        for name, arr in tables.items():
            self.register_buffer(name, torch.as_tensor(arr, device=device))
        if self.epi_note:
            trace.note(self.epi_note)

    def retune(self, tuning):
        """Record ``tuning`` as ``self.tuning`` and the launch geometry it
        gives each pass as ``pass_geometry`` (a plan's ``lane_tile``
        override kept): pass 1 runs on [B, R, C] = ``block_in_shape``, pass
        2 on pass 1's turned output, [B, C, R]; each on the int64 tile
        where it stores int64.  The build calls it with the device's row;
        ``tools/sweep_tuning.py`` with the rows it times.  The form of
        ``fuse="auto"`` is taken anew from the row, and the whole form's
        cluster (``fused_whole``, ``whole_geometry``; a wide plan's from
        its int64 tile and receive buffer).  The prepared chains
        and the captured graphs of the old geometry are dropped."""
        r, c = self.block_in_shape
        self.invalidate()
        self.tuning = tuning
        self.pass_geometry = tuple(
            pass_geometry(tuning, rows, cols, dt == torch.int64,
                          self.lane_tile)
            for rows, cols, dt in ((r, c, self.mid_dtype),
                                   (c, r, self.out_dtype)))
        sizes = self.mid_dtype.itemsize, self.out_dtype.itemsize
        narrow = not (self.wide_in or self.wide1 or self.wide2)
        fits = whole_cluster(tuning, r, c, *sizes) is not None
        if self.fuse == "whole" and not fits:
            raise ValueError(
                f"fuse='whole' holds n <= {whole_capacity(tuning, *sizes)} "
                f"on {self.in_dtype} -> {self.mid_dtype} -> "
                f"{self.out_dtype} blocks (a cluster of at most "
                f"{MAX_CLUSTER} CTAs of {tuning.smem_per_cta} bytes of "
                f"shared memory); got n = {self.cfg.n} as {r} x {c}: use "
                f"fuse='split'")
        self.fused_whole = self.fuse == "whole" or (
            self.fuse == "auto" and narrow and fits
            and self.epi_mode != "inkernel"
            and self.cfg.n <= tuning.whole_max_n)
        # the cluster is chosen per batch when a call is prepared
        # (PreparedWhole)
        geometry = dict(batch_block=self.batch_block, cluster=None)
        self.whole_geometry = (types.MappingProxyType(geometry)
                               if self.fused_whole else None)

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
        each must match its buffer's shape.  The buffers are written in
        place, so the prepared chains and captured graphs, which read them
        by address, see the new tables."""
        bufs = dict(self.named_buffers())
        for name, t in tables.items():
            buf = bufs.get(name)
            if buf is None or tuple(t.shape) != tuple(buf.shape):
                raise ValueError(f"table {name} {tuple(t.shape)} matches no "
                                 f"buffer of this plan")
            buf.copy_(t)

    def passes(self, window: Edges | None = None, cut: Edges | None = None):
        """The two passes of ``apply_blocks`` as (cfg, keyword arguments of
        ``fused_pass``), in order: the split form's two launches, and what
        the whole form runs in its one (``fused_whole(x_re, x_im,
        plan.passes(), **plan.whole_geometry)``); their plain versions in
        turn are both forms' plain version.  ``window`` goes to pass 1,
        ``cut`` to pass 2, where given (``apply_blocks``)."""
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
        g1, g2 = self.pass_geometry
        if window is not None:
            one = dict(one, window=window)
        if cut is not None:
            two = dict(two, cut=cut)
        return [(self.cfg1, dict(one, transpose_out=True,
                                 out_dtype=self.mid_dtype, **g1, **kw)),
                (self.cfg2, dict(two, transpose_out=False,
                                 out_dtype=self.out_dtype, **g2, **kw))]

    def takes_edge(self, side: str, payload: int, lead: int) -> bool:
        """Whether the split chain's pass 1 (``side`` "window") or pass 2
        ("cut") can take the convolution's edge of ``payload`` and ``lead``
        (``Edges``, ``edge_fault``): the split form, blocks of payload +
        lead samples, the pass of the one form that carries the edge, the
        lead and the payload whole rows of its blocks."""
        if self.fused_whole or payload + lead != self.cfg.n:
            return False
        first = (1,) + self.block_in_shape
        i, shape, dtype = ((0, first, self.in_dtype) if side == "window"
                           else (1, _out_shape(first, self.cfg1, False, True),
                                 self.mid_dtype))
        cfg, kw = self.passes()[i]
        return edge_fault(side, Edges(payload, lead, payload), cfg, shape[2],
                          dtype, kw) is None

    def apply_blocks(self, xr, xi, pass_fn=None, window: Edges | None = None,
                     cut: Edges | None = None):
        """[B, *block_in_shape] blocks in ``in_dtype`` -> [B,
        *block_out_shape] blocks in ``out_dtype``: the two passes, every
        reorder inside them.  On a CUDA tensor the plan's ``PreparedChain``
        for this batch, dtype, device and edges (prepared at the first call
        with them) launches both passes in one C call, as two launches of
        the pass or, in the whole form, one of the cluster kernel; on a CPU
        tensor the plain version runs (through ``fused_whole`` in the whole
        form).  ``pass_fn`` runs the split form's passes one call each
        instead, whatever the form: ``fused_pass`` (its checks, resolution
        and C call per pass) or ``fused_pass_reference`` (the plain version
        on any device).

        The convolution's edges (``Edges``, split form only, where
        ``takes_edge``): with ``window`` pass 1 reads the blocks from the
        signal [S, length] ``xr``, ``xi`` in place; with ``cut`` pass 2
        writes the convolution's output [S, length] in place of the
        blocks."""
        edges = {k: v for k, v in (("window", window), ("cut", cut))
                 if v is not None}
        if edges and self.fused_whole:
            raise ValueError("the convolution's edges run on the split form")
        if pass_fn is None:
            if use_kernel(xr.device):
                key = (xr.shape, xr.dtype, xr.device)
                return self._prepare(key + (window, cut), lambda: (
                    PreparedChain(*key, self.passes(**edges),
                                  whole=self.whole_geometry)))(xr, xi)
            if self.fused_whole:
                return fused_whole(xr, xi, self.passes(),
                                   **self.whole_geometry)
            pass_fn = fused_pass
        for cfg, kw in self.passes(**edges):
            xr, xi = pass_fn(xr, xi, cfg, **kw)
        return xr, xi

    def capture(self):
        """``runtime.graph.captured(self.apply_blocks)``: ``apply_blocks``
        replayed from one CUDA graph per input (shape, dtype, device), the
        port's counterpart of the JAX plan's ``jax.jit``.  Its outputs are
        static: each call overwrites the previous call's outputs of the
        same key (see ``CapturedCall``).  ``retune`` and ``.to()`` drop its
        graphs."""
        from ..runtime.graph import captured

        return self._track(captured(self.apply_blocks))

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
