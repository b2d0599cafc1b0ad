"""Parallel execution layer of the port: the channelizer, overlap-save
convolution and the four-step FFT, each on one device or sharded over a
``torch.distributed`` device mesh (SPMD: each rank holds its shard)."""

from .channelizer import Channelizer
from .convolve import OverlapSaveConv
from .four_step import (FourStepPasses, FourStepPlan, column_pass,
                        corner_turn, local_plan, resolve_kernel, row_pass)
from .mesh import (CHANNEL_AXIS, FFT_AXIS, channel_sharding, gather,
                   make_mesh, replicated, shard, single_axis_size)
from .multihost import initialize_multihost, pod_mesh

__all__ = ["Channelizer", "FourStepPlan", "OverlapSaveConv", "CHANNEL_AXIS",
           "FFT_AXIS", "channel_sharding", "make_mesh", "replicated",
           "initialize_multihost", "pod_mesh", "FourStepPasses",
           "column_pass", "corner_turn", "gather", "local_plan",
           "resolve_kernel", "row_pass", "shard", "single_axis_size"]
