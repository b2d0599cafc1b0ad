"""Host runtime of the port: the native golden engine's bindings,
streaming execution on CUDA streams, calls captured into CUDA graphs, and
spans of the port's host code (``trace``)."""

from .graph import CapturedCall, captured
from .native import NativeGolden, native_available
from .stream import StreamExecutor

__all__ = ["CapturedCall", "NativeGolden", "StreamExecutor", "captured",
           "native_available"]
