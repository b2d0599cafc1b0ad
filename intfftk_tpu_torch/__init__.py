"""intfftk_tpu_torch — the PyTorch/CUDA port of intfftk_tpu for NVIDIA Hopper.

The JAX package ``intfftk_tpu`` stays the reference.  This package shares
its NumPy specification (``intfftk_tpu.config``, the twiddle tables and the
golden models, none of which imports JAX) and ports the compute path:

* ``ops.intmath``     — the exact butterfly arithmetic on int32/int64
  tensors, products of data up to 64 bits included;
* ``ops.transform``   — the eager staged transform, forward and inverse,
  ``FFTPlan`` and ``WideFFTPlan`` (outputs of 33..64 bits) (the CPU path
  and the plain version every kernel is held against);
* ``ops.fused_fft``   — ``fused_pass``, one launch of the hand-written CUDA
  kernel ``csrc/fused_pass.cu``, and ``LargeFFTPlan``, the large-n
  transform as two launches of it: four-step (its inter-factor twiddle
  from a host table, a device-generated table or synthesized in the
  kernel) or monolithic, natural or raw order, on int16/int32 blocks or,
  above 32 bits, int64 blocks;
* ``ops.twiddle_synth`` — the inter-factor twiddles from the 512-entry
  coarse quarter table: the generator kernel and its plain version;
* ``ops.single_pass`` — ``PallasFFTPlan`` and ``FusedAxisFFT``, the
  n <= 4096 engines, and ``PallasWideFFTPlan``, their int64 twin for data
  paths of 33..64 bits, one launch per call;
* ``parallel``        — ``Channelizer`` on one device;
* ``runtime``         — ``StreamExecutor`` on CUDA streams;
* ``device``          — where a call runs: the kernel on an sm_90 card, the
  plain version on the CPU.

Outputs are bit-identical to ``intfftk_tpu.golden`` and to the JAX plans.
"""

from intfftk_tpu.config import FFTConfig, snr_db

from .ops import PallasWideFFTPlan, WideFFTPlan

__all__ = ["FFTConfig", "snr_db", "PallasWideFFTPlan", "WideFFTPlan"]
