"""Cost accounting of the integer FFT kernels."""

from .roofline import (OPS_PER_SAMPLE_STAGE, KernelCost, fft_cost,
                       large_fft_cost, roofline_fraction)

__all__ = ["OPS_PER_SAMPLE_STAGE", "KernelCost", "fft_cost",
           "large_fft_cost", "roofline_fraction"]
