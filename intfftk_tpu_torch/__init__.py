"""intfftk_tpu_torch — the PyTorch/CUDA port of intfftk_tpu for NVIDIA Hopper.

The JAX package ``intfftk_tpu`` stays the reference.  This package imports
``torch``, never ``jax``, and nothing of ``intfftk_tpu``: it keeps its own
copy of the NumPy specification (``config``, ``golden``: the twiddle tables
and the golden models, name for name; ``convert.config_from_jax`` and
``conv_spec_from_jax`` carry a JAX-package config across) and ports the
compute path:

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
* ``parallel``        — ``Channelizer``, ``OverlapSaveConv`` (overlap-save
  convolution: forward, frequency product, inverse) and ``FourStepPlan``
  (the four-step FFT with all-to-all corner turns), on one device or
  sharded over a ``torch.distributed`` device mesh (``make_mesh``,
  ``pod_mesh``, ``initialize_multihost``; SPMD: each rank holds its
  shard), NCCL on the card, gloo on the CPU;
* ``runtime``         — ``StreamExecutor`` on CUDA streams, and
  ``NativeGolden``, the bindings of the repository's native C++ golden
  engine;
* ``utils``           — the ``.dat`` stimulus format, the two-lane stream
  formats, the cost model;
* ``entry``           — ``entry()``, the flagship step on one card, and
  ``dryrun_multiprocess(n)``, the distributed layer in n CPU processes;
  ``examples/``, the two walkthroughs;
* ``tools.probe_vpu`` — the card's integer-instruction and device-memory
  ceilings, measured by the hand-written kernels of ``csrc/probe.cu``
  (dependent op chains, a streaming copy); ``utils.roofline``, the cost
  model that turns them into each kernel's bound;
* ``device``          — where a call runs: the kernel on an sm_90 card, the
  plain version on the CPU.  Whatever owns buffers takes ``device=None``
  as the current CUDA device (``device.resolve``) and raises where there
  is none: the CPU is taken only with ``device="cpu"``.

Outputs are bit-identical to ``golden`` and to the JAX plans.
"""

from .config import FFTConfig, snr_db

from .ops import (FFTPlan, FusedAxisFFT, LargeFFTPlan, PallasFFTPlan,
                  PallasWideFFTPlan, WideFFTPlan)
from .parallel import (Channelizer, FourStepPlan, OverlapSaveConv,
                       initialize_multihost, make_mesh, pod_mesh)
from .runtime import StreamExecutor

__version__ = "0.1.0"

#: the config and every plan of the package
__all__ = ["FFTConfig", "snr_db", "__version__", "FFTPlan", "WideFFTPlan",
           "LargeFFTPlan", "PallasFFTPlan", "FusedAxisFFT",
           "PallasWideFFTPlan", "Channelizer", "OverlapSaveConv",
           "FourStepPlan", "StreamExecutor", "make_mesh", "pod_mesh",
           "initialize_multihost"]
