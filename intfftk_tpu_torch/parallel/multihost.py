"""Process-group bring-up and the host-spanning ('ch', 'fft') mesh.

Counterpart of ``intfftk_tpu/parallel/multihost.py:28-61``.  One process
drives one device.  The collectives of the parallel plans are the same
whatever the topology; this module only joins the process group and lays
the mesh out with ``fft`` (the all-to-all axis) innermost, so that its
groups are the ranks of one host, and ``ch`` (no communication) across the
hosts.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import CHANNEL_AXIS, FFT_AXIS, make_mesh


def _on_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device: torch.device | str | None = None) -> None:
    """Join the ``torch.distributed`` process group (idempotent: returns at
    once when it is up).

    ``coordinator``: "host:port" of rank 0's store (``tcp://``), or a URL
    such as ``file:///path`` used as given; None reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``env://``) for the
    arguments not given.  The backend is NCCL on the card and gloo only
    with ``device="cpu"``.  On the card the process first takes the card of
    its local rank (``LOCAL_RANK``, else ``process_id`` modulo the cards
    of the host), because every plan builds on the current device."""
    if dist.is_initialized():
        return
    cpu = _on_cpu(device)
    kw = {}
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to join '
                               'over gloo')
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if coordinator is None:
        init = "env://"
    else:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        "gloo" if cpu else "nccl", init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kw)


def local_device_count(device: torch.device | str | None = None) -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` where a launcher sets it,
    else the host's cards, or on the CPU the world size (one host)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if _on_cpu(device):
        return dist.get_world_size()
    return torch.cuda.device_count()


def pod_mesh(ch: int | None = None, fft: int | None = None,
             device: torch.device | str | None = None) -> DeviceMesh:
    """The global ('ch', 'fft') mesh over every rank of every host, ``fft``
    innermost (consecutive ranks: one host's devices).  Defaults: ``fft`` =
    ``local_device_count()``, ``ch`` = world size / ``fft`` (the hosts).
    ``device`` as ``make_mesh``."""
    world = dist.get_world_size()
    if fft is None:
        fft = local_device_count(device)
    if ch is None:
        ch = world // fft
    if ch * fft != world:
        raise ValueError(f"ch*fft = {ch * fft} != world size {world}")
    return make_mesh((ch, fft), (CHANNEL_AXIS, FFT_AXIS), device=device)
