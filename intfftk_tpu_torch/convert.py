"""Carry a JAX plan's tables across to the port.

The JAX plans thread their tables through jit as ``plan.consts``
(``intfftk_tpu/ops/pallas_fft.py``):

* ``PallasFFTPlan`` and ``FusedAxisFFT`` (:826, :1464): the packed stage
  tables ``w_re``/``w_im`` as [n, 1] columns;
* ``LargeFFTPlan`` (:1702-1710), in any direction and order: the
  inter-factor twiddles ``er``/``ei`` [n1, n2], and the packed stage
  tables of both factors, under ``"w"`` as ``w1r``, ``w1i``, ``w2r``,
  ``w2i`` (the whole-fused kernel, ``_FusedFourStep.consts``
  :1194-1195), or under ``"p1"``/``"p2"`` as ``w_re``/``w_im`` (the split
  pair of ``_FusedPass``).

``tables_from_jax`` maps them, as numpy arrays, onto the buffers of the
port's counterpart: ``LargeFFTPlan.load_tables``, or ``load_state_dict``
of ``PallasFFTPlan``/``FusedAxisFFT``.
"""

from __future__ import annotations

import numpy as np
import torch


def _vec(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int32).reshape(-1))


def tables_from_jax(consts: dict) -> dict[str, torch.Tensor]:
    """JAX plan consts (leaves as numpy) -> the port's buffers: ``w_re``,
    ``w_im`` ([n] int32) for a single-pass plan; ``w1r, w1i, w2r, w2i``
    ([n1], [n2] int32) and ``er, ei`` ([n1, n2] int32) for a
    ``LargeFFTPlan``."""
    if "er" not in consts:
        return {k: _vec(consts[k]) for k in ("w_re", "w_im")}
    if "w" in consts:
        out = {k: _vec(consts["w"][k]) for k in ("w1r", "w1i", "w2r", "w2i")}
    else:
        out = {f"w{f}{part}": _vec(consts[f"p{f}"][f"w_{name}"])
               for f in (1, 2) for part, name in (("r", "re"), ("i", "im"))}
    for k in ("er", "ei"):
        out[k] = torch.as_tensor(np.array(consts[k], np.int32))
    return out
