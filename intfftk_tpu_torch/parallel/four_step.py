"""The local-transform engine of the parallel plans.

Counterpart of ``intfftk_tpu/parallel/four_step.py:46-70``
(``resolve_kernel``, ``local_plan``).  The distributed ``FourStepPlan``
(all-to-all corner turns over ``torch.distributed``) is not ported yet:
ROADMAP Queue A, 'Distributed layer'.
"""

from __future__ import annotations

import torch

from ..config import FFTConfig

from ..device import resolve, use_kernel
from ..ops.fused_fft import MAX_ROWS
from ..ops.single_pass import FusedAxisFFT
from ..ops.transform import FFTPlan


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
