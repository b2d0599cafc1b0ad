"""Device meshes over ``torch.distributed``: the communication backend of
the parallel plans.

Counterpart of ``intfftk_tpu/parallel/mesh.py:23-53``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over every rank of the
process group, one device per rank, with the same two axes:

* ``ch``  — channel parallelism (no communication);
* ``fft`` — within-transform parallelism (the four-step's all-to-all
  corner turns, the convolution's halo).

An axis's process group is ``mesh.get_group(axis)``.  The mesh lives on
the card (NCCL) unless the caller asks for the CPU (gloo).

A torch program is SPMD: each rank holds its own shard, where a JAX array
is global.  So the JAX ``NamedSharding`` helpers become DTensor placements
(``channel_sharding``, ``replicated``), and two functions move data between
the global layout and a rank's shard: ``shard`` (this rank's contiguous
slice of a host array) and ``gather`` (all-gather back).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..device import resolve

CHANNEL_AXIS = "ch"
FFT_AXIS = "fft"


def make_mesh(shape=None, axis_names=(CHANNEL_AXIS,),
              device: torch.device | str | None = None) -> DeviceMesh:
    """A mesh over every rank of the process group (``initialize_multihost``
    first), laid out row-major: the last axis is innermost.  ``shape=None``
    puts every rank on the first axis.  ``device``: the card (NCCL) unless
    it names the CPU (gloo), as ``device.resolve``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost "
                           "first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {tuple(shape)} != world size {world}")
    return init_device_mesh(resolve(device).type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def single_axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank on ``mesh``: the current CUDA device, or the
    CPU."""
    return resolve("cpu" if mesh.device_type == "cpu" else None)


def plan_device(mesh: DeviceMesh | None, device) -> torch.device:
    """The device a plan builds on: ``device`` as ``device.resolve`` reads
    it, or, left out, the mesh's; a device of another type than the mesh's
    raises."""
    if mesh is None:
        return resolve(device)
    own = mesh_device(mesh)
    if device is None:
        return own
    device = resolve(device)
    if device.type != own.type:
        raise ValueError(f"device {device} is not on the {own.type} mesh")
    return device


def channel_sharding(mesh: DeviceMesh, ndim: int, axis: str = CHANNEL_AXIS):
    """DTensor placements splitting the leading (channel) dimension of an
    [channels, ..., n] batch over ``axis``, replicated over the other axes
    (``ndim`` kept from the JAX signature; a placement needs no rank)."""
    return tuple(Shard(0) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    return (Replicate(),) * mesh.ndim


def shard(x, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice along ``dim`` of ``x`` (a host array or
    tensor, the same on every rank), split evenly over ``axis``, on this
    rank's device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x))
    d = single_axis_size(mesh, axis)
    if t.shape[dim] % d:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"divide over {d} ranks on axis {axis!r}")
    k = t.shape[dim] // d
    part = t.narrow(dim, mesh.get_local_rank(axis) * k, k)
    return part.to(mesh_device(mesh)).contiguous()


def gather(y: torch.Tensor, mesh: DeviceMesh, axis: str,
           dim: int = 0) -> torch.Tensor:
    """The shards of ``axis`` joined along ``dim`` in rank order, on every
    rank (an all-gather on the axis's group)."""
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(single_axis_size(mesh, axis))]
    dist.all_gather(parts, y, group=mesh.get_group(axis))
    return torch.cat(parts, dim)
