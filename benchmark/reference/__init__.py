"""The benchmark's plain reference: a frozen NumPy copy of the integer
FFT's golden model.

``config``, ``int_model``, ``float_model``, ``twiddle``, ``four_step`` and
``convolve`` are copies of the port's ``config.py`` and ``golden/`` files
that ``four_step_int``, ``fft_int``, ``make_conv_spec`` and
``overlap_save_int`` need, frozen here so that no change to the port can
move what the port is held to.  ``blocks`` adds the overlap-save output of
chosen blocks of a signal, the same arithmetic restricted to those blocks.

This package imports numpy alone: nothing of the port, of jax or of the
JAX package (``benchmark/tests/test_bench_imports.py`` holds it so).  From
a configuration and the benchmark's own inputs it works out again
everything the port derives at set-up: stage and inter-factor twiddles,
the taps' spectrum.
"""

from .blocks import overlap_save_blocks
from .config import FFTConfig
from .convolve import (ConvSpec, make_conv_spec, overlap_save_int,
                       taps_spectrum_int)
from .four_step import four_step_int
from .int_model import fft_int

__all__ = ["FFTConfig", "ConvSpec", "make_conv_spec", "overlap_save_int",
           "taps_spectrum_int", "four_step_int", "fft_int",
           "overlap_save_blocks"]
