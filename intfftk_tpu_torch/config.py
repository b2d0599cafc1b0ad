"""Configuration surface of the integer FFT framework.

The port's own copy of ``intfftk_tpu/config.py``, name for name (the port
imports nothing of the JAX package; ``convert.config_from_jax`` carries a
config across, and tests/test_torch_spec.py holds the two equal).

Mirrors the capability surface of the reference generator's generics
(``reference/src/vhdl/fft/int_fftNk.vhd:72-84``):

=============  =====================  ==========================================
reference      here                   notes
=============  =====================  ==========================================
NFFT           ``log2(n)``            we take ``n`` directly (8 .. 512K native,
                                      beyond via the four-step decomposition)
FORMAT         ``mode``               1 -> "unscaled", 0 -> "scaled"
RNDMODE        ``rounding``           0 -> "truncate", 1 -> "round" (half-up)
DATA_WIDTH     ``data_width``         8..32 bits signed
TWDL_WIDTH     ``twiddle_width``      16..25(27) bits signed
RAMB_TYPE      (folded away)          WRAP/CONT strobe protocols are a streaming
                                      concern; blocks are batched host-side
XSER           (folded away)          DSP48E1/E2 split becomes TPU-generation
                                      tuning inside the Pallas kernels
USE_MLT        ``twiddle_gen``        rom / taylor policy for large stages
USE_FLY        ``bypass_fly``         debug: skip arithmetic, permutation only
=============  =====================  ==========================================

The deprecated string generic ``MODE`` ("UNSCALED"/"TRUNCATE"/"ROUNDING",
``int_fftNk.vhd:107-117``) maps onto (mode, rounding) exactly as the reference
decoder does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

Mode = Literal["unscaled", "scaled"]
Rounding = Literal["truncate", "round"]

#: Stages with twiddle index width >= this use the 512-entry coarse table plus
#: first-order Taylor correction (reference ``rom_twiddle_int.vhd:215-246``).
TAYLOR_STAGE = 11

#: Coarse quarter-wave table depth for Taylor stages (9 address bits -> 512).
TAYLOR_COARSE_BITS = 9


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class FFTConfig:
    """Static configuration of one transform plan.

    Every field is resolved at trace time — the TPU analog of VHDL generics
    resolved at elaboration. No runtime reconfiguration exists in either
    system.
    """

    n: int = 1024
    mode: Mode = "scaled"
    rounding: Rounding = "truncate"
    data_width: int = 16
    twiddle_width: int = 16
    #: "auto"/"taylor_old": quarter-wave ROM below TAYLOR_STAGE, Taylor
    #: interpolation above with the XSER="OLD" (DSP48E1) constant set —
    #: the reference default.  "taylor_new": the XSER="NEW" (DSP48E2)
    #: constants (``row_twiddle_tay.vhd:123-148``).  "rom" forces full
    #: quarter-wave tables for every stage (more accurate than the
    #: reference for huge N; useful when isolating Taylor error).  The
    #: USE_MLT generic has no knob: its two paths are bit-identical
    #: (``golden.twiddle.taylor_mpi``).
    twiddle_gen: Literal["auto", "taylor_old", "taylor_new", "rom"] = "auto"
    #: Debug bypass of butterfly arithmetic (reference USE_FLY,
    #: ``int_fftNk.vhd:89,259-277``): data traverses only the permutation
    #: network, so dataflow plumbing can be verified in isolation.
    bypass_fly: bool = False

    def __post_init__(self):
        if not _is_pow2(self.n) or self.n < 8:
            raise ValueError(f"n must be a power of two >= 8, got {self.n}")
        if self.mode not in ("unscaled", "scaled"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.rounding not in ("truncate", "round"):
            raise ValueError(f"bad rounding {self.rounding!r}")
        # The reference's *input* contract is 8..32 bits
        # (int_fft_single_path.vhd:15); wider values arise internally when an
        # unscaled FFT feeds an IFFT (pair widens input to DATA_WIDTH+NFFT,
        # int_fft_ifft_pair.vhd:261), so the ceiling here is the widest
        # post-growth width: 32 + 19 stages.
        if not (8 <= self.data_width <= 52):
            raise ValueError(f"data_width must be in [8, 52], got {self.data_width}")
        if not (16 <= self.twiddle_width <= 27):
            raise ValueError(
                f"twiddle_width must be in [16, 27], got {self.twiddle_width}"
            )
        if self.twiddle_gen not in ("auto", "taylor_old", "taylor_new",
                                    "rom"):
            raise ValueError(f"bad twiddle_gen {self.twiddle_gen!r}")

    # ------------------------------------------------------------------ sizes

    @property
    def stages(self) -> int:
        """log2(n) — number of radix-2 stages (reference generic NFFT)."""
        return self.n.bit_length() - 1

    @property
    def scale(self) -> int:
        """1 for scaled (per-stage /2), 0 for unscaled (reference SCALE)."""
        return 1 if self.mode == "scaled" else 0

    @property
    def output_width(self) -> int:
        """Bit width of the transform output.

        Unscaled grows one bit per stage (``int_fftNk.vhd:97-100``:
        FORMAT*NFFT + DATA_WIDTH); scaled output width equals the input width.
        """
        if self.mode == "unscaled":
            return self.data_width + self.stages
        return self.data_width

    def stage_input_width(self, s: int) -> int:
        """Data width entering stage ``s`` (0-based from the first DIF stage).

        Reference: width at stage ii is ``DATA_WIDTH + ii*FORMAT``
        (``int_fftNk.vhd:119,193``).
        """
        if self.mode == "unscaled":
            return self.data_width + s
        return self.data_width

    def stage_twiddle_order(self, s: int, inverse: bool = False) -> int:
        """Twiddle order p of stage ``s``: the stage uses W = exp(∓jπk/2^p).

        Forward DIF: p = stages-1-s (reference ``int_fftNk.vhd:223``,
        STAGE => NFFT-ii-1).  Inverse DIT: p = s (``int_ifftNk.vhd:189``).
        """
        return s if inverse else self.stages - 1 - s

    # -------------------------------------------------------------- twiddles

    @property
    def twiddle_magnitude(self) -> int:
        """Integer magnitude of quantized twiddles.

        2^(w-1)-1 below 18 bits, 2^(w-2)-1 at >= 18 bits (DSP headroom rule,
        reference ``rom_twiddle_int.vhd:143-147``).
        """
        w = self.twiddle_width
        return (1 << (w - 1)) - 1 if w < 18 else (1 << (w - 2)) - 1

    @property
    def twiddle_shift(self) -> int:
        """Right-shift renormalizing a data x twiddle product.

        Product slice ``P(DTW+TWD-2 downto TWD-1)`` for twiddle width <= 18,
        i.e. >> (TWD-1); one less for wider twiddles
        (``int_cmult_dsp48.vhd:189-190, 316-317``).
        """
        w = self.twiddle_width
        return w - 1 if w < 19 else w - 2

    # ---------------------------------------------------------- reference MODE

    @classmethod
    def from_reference_mode(cls, n: int, mode: str, **kw) -> "FFTConfig":
        """Build from the deprecated reference MODE string
        (decoder mirrored from ``fft_signle_test.vhd:81-88``)."""
        m = mode.upper()
        if m == "UNSCALED":
            return cls(n=n, mode="unscaled", rounding="truncate", **kw)
        if m == "TRUNCATE":
            return cls(n=n, mode="scaled", rounding="truncate", **kw)
        if m == "ROUNDING":
            return cls(n=n, mode="scaled", rounding="round", **kw)
        raise ValueError(f"unknown reference MODE {mode!r}")

    def describe(self) -> str:
        return (
            f"FFTConfig(n={self.n}, {self.mode}/{self.rounding}, "
            f"data {self.data_width}b, twiddle {self.twiddle_width}b, "
            f"out {self.output_width}b)"
        )


def snr_db(ref, test) -> float:
    """Output SNR of ``test`` against float reference ``ref`` in dB."""
    import numpy as np

    ref = np.asarray(ref, dtype=np.complex128).ravel()
    test = np.asarray(test, dtype=np.complex128).ravel()
    err = ref - test
    p_sig = float(np.sum(np.abs(ref) ** 2))
    p_err = float(np.sum(np.abs(err) ** 2))
    if p_err == 0.0:
        return math.inf
    return 10.0 * math.log10(p_sig / p_err)
