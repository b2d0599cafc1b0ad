"""Golden models: the executable specification of the framework.

The only deliberately host-side (NumPy) layer — everything the TPU compute
path produces is validated against these, the same way the reference
validates RTL against ``math/fn_radix2.m``.

The port's own copy of ``intfftk_tpu/golden/``, file for file and name for
name: NumPy only, held equal to the original by tests/test_torch_spec.py.
"""

from .convolve import (ConvSpec, make_conv_spec, overlap_save_int,
                       taps_spectrum_int)
from .float_model import (bitrev_indices, cross_commutate,
                          cross_commutate_inv, fft_dif_float, fft_dit_float)
from .four_step import four_step_float, four_step_int
from .int_model import (cmult_int, dif_butterfly_int, dit_butterfly_int,
                        fft_int, neg_guarded, round_half_up, wrap_width)
from .lane_model import fft_int_lanes
from .sanitize import OverflowReport, check_overflow
from .stimulus import chirp_stimulus, random_stimulus
from .twiddle import magnitude, quarter_table, stage_twiddles_float, \
    stage_twiddles_int

__all__ = [
    "ConvSpec", "make_conv_spec", "overlap_save_int", "taps_spectrum_int",
    "four_step_float", "four_step_int",
    "bitrev_indices", "cross_commutate", "cross_commutate_inv",
    "fft_dif_float", "fft_dit_float", "cmult_int", "dif_butterfly_int",
    "dit_butterfly_int", "fft_int", "neg_guarded", "round_half_up",
    "wrap_width", "fft_int_lanes", "chirp_stimulus", "random_stimulus",
    "OverflowReport", "check_overflow",
    "magnitude", "quarter_table", "stage_twiddles_float",
    "stage_twiddles_int",
]
