"""Host runtime of the port: streaming execution on CUDA streams."""

from .stream import StreamExecutor

__all__ = ["StreamExecutor"]
