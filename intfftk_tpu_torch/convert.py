"""Carry a JAX ``LargeFFTPlan``'s state across to the port.

The JAX plan threads its tables through jit as ``plan.consts``
(``intfftk_tpu/ops/pallas_fft.py:1702-1710``): the inter-factor twiddles
``er``/``ei`` [n1, n2] and, under ``"w"``, the packed stage tables of both
factors as [n, 1] columns (``w1r``, ``w1i``, ``w2r``, ``w2i``, the
whole-fused kernel's form, ``_FusedFourStep.consts`` :1194-1195).
``tables_from_jax`` maps them, as numpy arrays, onto the buffers of the
port's ``LargeFFTPlan`` (``plan.load_tables``).
"""

from __future__ import annotations

import numpy as np
import torch


def tables_from_jax(consts: dict) -> dict[str, torch.Tensor]:
    """JAX ``LargeFFTPlan.consts`` (leaves as numpy) -> the port's buffers
    ``w1r, w1i, w2r, w2i`` ([n] int32) and ``er, ei`` ([n1, n2] int32)."""
    stage = consts["w"]
    out = {k: torch.as_tensor(np.array(stage[k], np.int32).reshape(-1))
           for k in ("w1r", "w1i", "w2r", "w2i")}
    for k in ("er", "ei"):
        out[k] = torch.as_tensor(np.array(consts[k], np.int32))
    return out
