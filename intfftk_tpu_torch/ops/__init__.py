"""Compute path of the port: eager PyTorch stages and the CUDA kernels."""

from .fused_fft import LargeFFTPlan, fused_pass, fused_pass_reference
from .intmath import (cmult_exact, neg_guarded, round_half_up,
                      spectrum_product, spectrum_product_reference,
                      wrap_width)
from .single_pass import FusedAxisFFT, PallasFFTPlan, PallasWideFFTPlan
from .transform import (FFTPlan, WideFFTPlan, fft, fft_ifft_pair, ifft,
                        make_plan)

__all__ = ["LargeFFTPlan", "fused_pass", "fused_pass_reference",
           "cmult_exact", "neg_guarded", "round_half_up", "wrap_width",
           "spectrum_product", "spectrum_product_reference",
           "FusedAxisFFT", "PallasFFTPlan", "PallasWideFFTPlan", "FFTPlan",
           "WideFFTPlan", "fft", "fft_ifft_pair", "ifft", "make_plan"]
