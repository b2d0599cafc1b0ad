"""Utilities: reference-format stimulus IO, the two-lane stream formats,
and the cost accounting of the integer FFT kernels."""

from .dat_io import read_dat, write_dat
from .lanes import (bitrev_pair, bitrev_pair_indices, halves_to_interleave2,
                    interleave2_to_halves, merge_halves, split_halves)
from .roofline import (OPS_PER_SAMPLE_STAGE, KernelCost, fft_cost,
                       large_fft_cost, roofline_fraction)

__all__ = ["read_dat", "write_dat", "bitrev_pair", "bitrev_pair_indices",
           "halves_to_interleave2", "interleave2_to_halves", "merge_halves",
           "split_halves", "OPS_PER_SAMPLE_STAGE", "KernelCost", "fft_cost",
           "large_fft_cost", "roofline_fraction"]
