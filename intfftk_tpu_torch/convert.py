"""Carry a JAX plan's config and tables across to the port.

The port keeps its own copy of the spec, so its ``FFTConfig`` and
``ConvSpec`` are other classes than the JAX package's, with the same
fields.  ``config_from_jax`` and ``conv_spec_from_jax`` rebuild one from
the other field by field; neither names a JAX-package class.

The JAX plans thread their tables through jit as ``plan.consts``
(``intfftk_tpu/ops/pallas_fft.py``):

* ``PallasFFTPlan``, ``FusedAxisFFT`` and ``PallasWideFFTPlan`` (:826,
  :1464, :739): the packed stage tables ``w_re``/``w_im`` as [n, 1]
  columns;
* ``LargeFFTPlan`` (:1639-1710), four-step schedule, in any direction and
  order: the packed stage tables of both factors, under ``"w"`` as
  ``w1r``, ``w1i``, ``w2r``, ``w2i`` (the whole-fused kernel,
  ``_FusedFourStep.consts`` :1194-1195), or under ``"p1"``/``"p2"`` as
  ``w_re``/``w_im`` (the split pair of ``_FusedPass``); the inter-factor
  twiddles ``er``/``ei`` [n1, n2] (host-built, or generated on the device
  in the split pipeline's device mode, :1668-1676), or, in its in-kernel
  mode, no table but the coarse table ``p1["tw_tbl"]``, packed
  (re & 0xFFFF) | (im << 16) into [4, 128] (``twiddle_synth.
  packed_coarse``); a wide plan (``wide1``/``wide2``) has the same int32
  tables;
* ``LargeFFTPlan``, monolithic schedule (:1639-1659): the standard
  factor's packed tables under ``"w"`` as ``wsr``/``wsi``, the 2-D stage
  tables as ``er``/``ei`` [n1, n2], and ``mrev``, the lane gather's index
  (the port's kernel does that reorder itself; it is dropped).

``tables_from_jax`` maps them, as numpy arrays, onto the buffers of the
port's counterpart: ``LargeFFTPlan.load_tables`` (the four-step's
``w1r`` ... ``ei``, or ``coarse_re``/``coarse_im``; the monolithic
``wsr``, ``wsi``, ``t2r``, ``t2i``), or ``load_state_dict`` of
``PallasFFTPlan``/``FusedAxisFFT``/``PallasWideFFTPlan``.

The sharded ``FourStepPlan`` (``intfftk_tpu/parallel/four_step.py:114-116``)
holds the full circle table ``w_re``/``w_im`` [n] and gathers W[m] per
shard, and the factor plans' consts ``p1``/``p2`` (``FusedAxisFFT``'s
packed columns, or the staged ``FFTPlan``'s per-stage tables).
``four_step_tables_from_jax`` turns them into the state of one rank's
``parallel.FourStepPasses``: that rank's epilogue slice ``er``/``ei``
[n1, n2/D] and the packed tables of ``plan1``/``plan2``.

The JAX wide path carries a value as two int32 planes, v = hi * 2^24 + lo
with lo in [0, 2^24) (``intfftk_tpu/ops/wideint.py:13-16``); the port
carries int64.  ``int64_from_planes`` and ``planes_from_int64`` convert
between the two, so plane-level JAX functions can be fed and read back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import FFTConfig
from .golden.convolve import ConvSpec


def _fields(obj, cls) -> dict:
    """The fields of dataclass instance ``obj`` that ``cls`` declares; a
    field ``cls`` lacks, or ``obj`` lacks, raises."""
    have = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    want = {f.name for f in dataclasses.fields(cls)}
    if set(have) != want:
        raise TypeError(f"{type(obj).__name__} has fields {sorted(have)}, "
                        f"{cls.__name__} takes {sorted(want)}")
    return have


def config_from_jax(cfg) -> FFTConfig:
    """The port's ``FFTConfig`` with the fields of a JAX-package one (or of
    any dataclass with the same fields; the port's own passes through)."""
    if isinstance(cfg, FFTConfig):
        return cfg
    return FFTConfig(**_fields(cfg, FFTConfig))


def conv_spec_from_jax(spec) -> ConvSpec:
    """The port's ``ConvSpec`` with the fields of a JAX-package one, its
    ``cfg`` through ``config_from_jax``."""
    if isinstance(spec, ConvSpec):
        return spec
    return ConvSpec(**dict(_fields(spec, ConvSpec),
                           cfg=config_from_jax(spec.cfg)))


#: Bits of the JAX wide path's low plane (``wideint.LO_BITS``).
LO_BITS = 24


def int64_from_planes(lo, hi) -> torch.Tensor:
    """JAX (lo, hi) int32 planes -> the int64 tensor hi * 2^24 + lo."""
    lo, hi = (torch.from_numpy(np.array(p, np.int64)) for p in (lo, hi))
    return (hi << LO_BITS) + lo


def planes_from_int64(x) -> tuple[np.ndarray, np.ndarray]:
    """int64 values (a tensor or an array) -> JAX (lo, hi) int32 planes,
    exact for values in [-2^55, 2^55), where hi fits int32."""
    x = np.asarray(torch.as_tensor(x).cpu(), np.int64)
    return ((x & ((1 << LO_BITS) - 1)).astype(np.int32),
            (x >> LO_BITS).astype(np.int32))


def _vec(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32).reshape(-1))


def _mat(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32))


def unpack_coarse(packed) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX [4, 128] packed coarse table -> two int32 [512] tensors: the
    signed low and high 16-bit halves of each word."""
    v = _vec(packed)
    return (v << 16) >> 16, v >> 16


def tables_from_jax(consts: dict) -> dict[str, torch.Tensor]:
    """JAX plan consts (leaves as numpy) -> the port's buffers: ``w_re``,
    ``w_im`` ([n] int32) for a single-pass plan; for a ``LargeFFTPlan``,
    ``w1r, w1i, w2r, w2i`` ([n1], [n2] int32) with ``er, ei`` ([n1, n2]
    int32) or ``coarse_re, coarse_im`` ([512] int32), or, monolithic,
    ``wsr, wsi`` and ``t2r, t2i`` ([n1, n2] int32)."""
    if "p1" in consts:
        out = {f"w{f}{part}": _vec(consts[f"p{f}"][f"w_{name}"])
               for f in (1, 2) for part, name in (("r", "re"), ("i", "im"))}
        if "tw_tbl" in consts["p1"]:
            out["coarse_re"], out["coarse_im"] = unpack_coarse(
                consts["p1"]["tw_tbl"])
    elif "w" in consts and "wsr" in consts["w"]:
        return {"wsr": _vec(consts["w"]["wsr"]),
                "wsi": _vec(consts["w"]["wsi"]),
                "t2r": _mat(consts["er"]), "t2i": _mat(consts["ei"])}
    elif "w" in consts:
        out = {k: _vec(consts["w"][k]) for k in ("w1r", "w1i", "w2r", "w2i")}
    else:
        return {k: _vec(consts[k]) for k in ("w_re", "w_im")}
    if "er" in consts:
        out["er"], out["ei"] = _mat(consts["er"]), _mat(consts["ei"])
    return out


def _factor_tables(consts, prefix: str) -> dict[str, torch.Tensor]:
    """A JAX factor plan's consts -> ``prefix.w_re``/``w_im`` [n]: the
    packed columns of the Pallas plan, or the staged plan's per-stage
    tables packed by order (order p at [2^p, 2^(p+1)), its table's length
    2^p)."""
    if "w_re" in consts:
        w = [_vec(consts["w_re"]), _vec(consts["w_im"])]
    else:
        w = np.zeros((2, len(consts["bitrev"])), np.int32)
        for re, im in consts["tables"].values():
            k = len(re)
            w[0, k:2 * k], w[1, k:2 * k] = re, im
        w = [torch.as_tensor(v) for v in w]
    return {f"{prefix}.w_re": w[0], f"{prefix}.w_im": w[1]}


def four_step_tables_from_jax(consts: dict, n1: int, n2: int, inverse: bool,
                              rank: int, size: int) -> dict[str, torch.Tensor]:
    """A JAX ``FourStepPlan``'s consts (leaves as numpy) -> the state dict
    of the port's ``FourStepPasses`` for rank ``rank`` of ``size``: ``er``,
    ``ei`` = W[m], m = k1 * j2 mod n (negated for the inverse) over that
    rank's global columns j2, as the JAX plan gathers it per shard; and
    ``plan1.w_re`` ... ``plan2.w_im``."""
    n, w = n1 * n2, n2 // size
    j2 = rank * w + np.arange(w)
    m = (np.arange(n1)[:, None] * j2[None, :]) % n
    if inverse:
        m = (n - m) & (n - 1)
    wr, wi = (np.asarray(consts[k]).reshape(-1) for k in ("w_re", "w_im"))
    out = {"er": _mat(wr[m]), "ei": _mat(wi[m])}
    out.update(_factor_tables(consts["p1"], "plan1"))
    out.update(_factor_tables(consts["p2"], "plan2"))
    return out
