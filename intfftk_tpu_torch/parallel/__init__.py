"""Parallel execution layer of the port, one device so far: the
channelizer, overlap-save convolution and the local-transform engine of
the parallel plans."""

from .channelizer import Channelizer
from .convolve import OverlapSaveConv
from .four_step import local_plan, resolve_kernel

__all__ = ["Channelizer", "OverlapSaveConv", "local_plan", "resolve_kernel"]
