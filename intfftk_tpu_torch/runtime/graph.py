"""CUDA graphs of the port's calls: ``captured(fn)``, the counterpart of
``jax.jit``.

In the JAX package every plan's call is one compiled executable:
``jax.jit`` wraps ``LargeFFTPlan._apply_flat``
(``intfftk_tpu/ops/pallas_fft.py:1808``), ``PallasFFTPlan`` and
``PallasWideFFTPlan`` (``:893``, ``:781``), ``FusedAxisFFT`` (``:1478``)
and ``OverlapSaveConv`` (``parallel/convolve.py:222``), and the reference's
benchmark times K chained calls as one ``jit(scan)`` dispatch
(``bench.py:92-106``).  Eager PyTorch issues every kernel launch and every
glue op of a call from the host, and at the 64k path's size the host took
about as long to issue a call as the card took to run it.
``captured(fn)`` records one call of ``fn`` on CUDA tensors into a CUDA
graph per (shapes, dtypes, device) of its arguments and replays the graph
on later calls: one host call per call, every launch and glue op of ``fn``
on the card.  The plans offer it as ``plan.capture()``.
"""

from __future__ import annotations

import time

import torch

from . import trace

#: the profiler's state, read on every call (``trace.profiler``)
_profiler = trace.profiler


def _counters():
    """The port's launch counters: the functions whose ``launches``
    attribute counts their kernel's launches."""
    from ..ops.fused_fft import fused_pass, fused_whole
    from ..ops.intmath import spectrum_product
    from ..ops.twiddle_synth import device_circle_table

    return (fused_pass, fused_whole, spectrum_product, device_circle_table)


class _Graph:
    """One capture: the graph, its static inputs and outputs, and the
    launches one replay makes, by counter."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.launches = outputs, launches


class _Open:
    """A span of ``CapturedCall.__call__``, open from its construction to
    ``close()``: a range of the profiler's trace where ``ranged``, and its
    start and end on the clock where ``rec`` (the open recording) is
    given."""

    __slots__ = ("range", "timed", "start", "end")

    def __init__(self, name, ranged, rec):
        self.range = trace.Range(name) if ranged else None
        if ranged:
            self.range.__enter__()
        self.timed = rec is not None
        self.start = time.time_ns() if self.timed else 0
        self.end = 0

    def close(self):
        if self.timed:
            self.end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)


class CapturedCall:
    """``fn`` on CUDA tensors, replayed from one CUDA graph per key: the
    shapes and dtypes of its positional arguments and their device.

    The first call with a key runs ``fn`` once on a side stream (the
    warm-up, as ``torch.cuda.graphs`` asks: it also takes every first-time
    path, such as the kernel library's build, the shared-memory grant and
    the plans' prepared chains), copies the arguments into static inputs,
    captures ``fn`` on them into a graph and replays it.  Every later call
    copies its arguments into the static inputs (an argument that is its
    static input, ``static_inputs(*args)``, is not copied) and replays the
    graph.  Everything ``fn`` does is replayed as captured: its Python runs
    only in the warm-up and the capture.

    **The outputs are static.**  Every call with a key returns the same
    tensors, and each replay writes them anew: an output is valid until the
    next call of this ``CapturedCall`` with the same key (clone it to keep
    it longer).  This is torch's own idiom for graphs.

    Launch counters (``fused_pass.launches``, ``fused_whole.launches``,
    ``spectrum_product.launches``) count what ran on the card: the
    warm-up's launches, none for the capture (what it added is taken off
    again) and, on every replay, the launches of one eager call.

    No fallback: arguments that are not CUDA tensors (an array or a CPU
    tensor would be a host copy inside the graph) or that lie on two
    devices raise ValueError, and a capture that fails raises; nothing runs
    eagerly in its place.  ``fn`` must not synchronise with the host
    (``.item()``, ``torch.equal``, a copy to the host).  The capture runs in
    the ``"thread_local"`` error mode: CUDA calls that other threads of the
    process make meanwhile do not invalidate it.

    ``reset()`` drops every graph (the plans call it from ``retune`` and
    ``.to()``); the next call captures again."""

    def __init__(self, fn):
        self.fn = fn
        self._graphs = {}

    def reset(self):
        """Drop every graph and its memory."""
        self._graphs.clear()

    @staticmethod
    def _key(args):
        if not args:
            raise ValueError("a captured call takes its tensors as "
                             "positional arguments; none were given")
        for a in args:
            if not isinstance(a, torch.Tensor) or not a.is_cuda:
                what = (f"a tensor on {a.device}"
                        if isinstance(a, torch.Tensor) else type(a).__name__)
                raise ValueError(
                    f"a captured call takes CUDA tensors only, got {what}: "
                    f"copy the input to the card first (a host copy cannot "
                    f"be replayed), or call the module itself on the CPU")
        dev = args[0].device
        if any(a.device != dev for a in args):
            raise ValueError(
                f"a captured call takes tensors on one device, got "
                f"{sorted({str(a.device) for a in args})}")
        return (dev, *((a.shape, a.dtype) for a in args))

    def static_inputs(self, *args):
        """The static inputs of the graph of ``args``'s key (None before its
        first call): write a call's input into them to save the copy."""
        g = self._graphs.get(self._key(args))
        return None if g is None else g.inputs

    def __call__(self, *args):
        """One call: the key, the capture (first call) or the copies into
        the static inputs, the replay and the counters.  In each sink that
        is on (``trace``) the call is a ``graph.call`` span holding
        ``graph.copy_in`` (where a copy is made) and ``graph.launch`` (the
        replay alone): the profiler's ranges open and close around these
        statements, and the recording's spans are read on the clock and
        recorded after the call's end.  The first call with a key is
        set-up: its ``graph.capture`` is a span of its own, no
        ``graph.launch`` is opened, and the recording keeps no
        ``graph.call``.  With both sinks off no clock is read and no span
        object is built."""
        rec, ranged = trace.active, _profiler._is_profiler_enabled
        whole = (_Open("graph.call", ranged, rec)
                 if ranged or rec is not None else None)
        try:
            key = self._key(args)
            g = self._graphs.get(key)
            first = g is None
            copy = launch = None
            if first:
                g = self._graphs[key] = self._capture(key[0], args)
            else:
                for s, a in zip(g.inputs, args):
                    if (a.data_ptr() != s.data_ptr()
                            or a.stride() != s.stride()):
                        if copy is None and whole is not None:
                            copy = _Open("graph.copy_in", ranged, rec)
                        s.copy_(a)
                if copy is not None:
                    copy.close()
            with torch.cuda.device(key[0]):
                if whole is not None and not first:
                    launch = _Open("graph.launch", ranged, rec)
                g.graph.replay()
                if launch is not None:
                    launch.close()
            for counter, n in g.launches:
                counter.launches += n
        finally:
            if whole is not None:
                whole.close()
        if rec is not None and launch is not None:
            i = rec.add("graph.call", whole.start, whole.end, call=True)
            if copy is not None:
                rec.add("graph.copy_in", copy.start, copy.end, i)
            rec.add("graph.launch", launch.start, launch.end, i)
        return g.outputs

    @trace.spanned("graph.capture")
    def _capture(self, dev, args) -> _Graph:
        counters = _counters()
        with torch.cuda.device(dev):
            inputs = tuple(a.clone(memory_format=torch.contiguous_format)
                           for a in args)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn(*inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = [c.launches for c in counters]
            try:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    outputs = self.fn(*inputs)
            finally:
                added = [c.launches - b for c, b in zip(counters, before)]
                for c, b in zip(counters, before):
                    c.launches = b          # the capture ran nothing
        return _Graph(graph, inputs, outputs,
                      tuple((c, n) for c, n in zip(counters, added) if n))


def captured(fn) -> CapturedCall:
    """``fn``, a callable on CUDA tensors, as a ``CapturedCall``: one CUDA
    graph per (shapes, dtypes, device) of its arguments, replayed on every
    call.  Its outputs are static (valid until the next call with the same
    key), and CPU tensors raise: see ``CapturedCall``."""
    return CapturedCall(fn)
