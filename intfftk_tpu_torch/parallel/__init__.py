"""Parallel execution layer of the port, one device so far: the
channelizer and the local-transform engine of the parallel plans."""

from .channelizer import Channelizer
from .four_step import local_plan, resolve_kernel

__all__ = ["Channelizer", "local_plan", "resolve_kernel"]
