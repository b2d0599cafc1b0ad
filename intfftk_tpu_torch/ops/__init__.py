"""Compute path of the port: eager PyTorch stages and the CUDA kernels."""

from .fused_fft import LargeFFTPlan, fused_pass, fused_pass_reference
from .intmath import cmult_exact, neg_guarded, round_half_up, wrap_width
from .transform import FFTPlan

__all__ = ["LargeFFTPlan", "fused_pass", "fused_pass_reference",
           "cmult_exact", "neg_guarded", "round_half_up", "wrap_width",
           "FFTPlan"]
