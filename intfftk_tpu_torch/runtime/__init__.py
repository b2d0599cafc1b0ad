"""Host runtime of the port: the native golden engine's bindings and
streaming execution on CUDA streams."""

from .native import NativeGolden, native_available
from .stream import StreamExecutor

__all__ = ["NativeGolden", "native_available", "StreamExecutor"]
