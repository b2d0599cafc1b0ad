"""Where a call runs: the CUDA kernels on a Hopper card, the plain version
on the CPU.

Counterpart of ``intfftk_tpu.ops.pallas_fft.infer_interpret`` and
``intfftk_tpu.ops.tuning.device_tuning``.  The tensor a call is given
decides, never global state: a CUDA tensor takes the kernel path and must
live on an sm_90 card; a CPU tensor takes the plain PyTorch version.  Any
other device raises.

Whatever owns buffers or a device (the plans, ``Channelizer``,
``StreamExecutor``, ``OverlapSaveConv``) takes a ``device`` argument and
passes it through ``resolve``: left out, it is the current CUDA device;
the CPU is taken only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

#: Compute capability the kernels are built for (``-arch sm_90a``).
KERNEL_CAPABILITY = (9, 0)


def use_kernel(device: torch.device | str) -> bool:
    """True when work on ``device`` launches the CUDA kernels, False when it
    runs the plain PyTorch version (CPU).  Raises for a CUDA device that is
    not sm_90 and for any other device type."""
    device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise RuntimeError(
            f"no compute path for device {device}: use a CUDA sm_90 device "
            f"or the CPU")
    cap = torch.cuda.get_device_capability(device)
    if cap != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}; "
            f"the kernels are built for sm_90a (Hopper)")
    return True


def resolve(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point builds on: ``device`` itself, or with
    ``None`` the current CUDA device.  There is no fallback: with ``None``
    and no CUDA device this raises RuntimeError (pass ``device="cpu"`` to
    run the plain version on the CPU), and a CUDA device must pass
    ``use_kernel``'s sm_90 check."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: the port runs on the card unless the '
                'caller asks for the CPU; pass device="cpu" to run the '
                'plain version there')
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    use_kernel(device)
    return device
