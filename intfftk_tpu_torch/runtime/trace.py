"""Spans of the port's host code, in two sinks: a recording in memory on
the profiler's clock, and ranges of torch's profiler.

A span is one stretch of the host's time inside the port, under a name.

**The recording.**  While a ``recording()`` is open, ``on`` is True and
``active`` is the ``Recording``: each span is kept with its start and end
in ns of ``time.time_ns()``, the index of the span that encloses it (-1
at a root) and the call it belongs to: the sequence number of its
``graph.call`` in the recording, -1 outside any call (the set-up).
``time.time_ns()`` is the clock that ``torch.profiler`` stamps its host
ranges with, and CUPTI's device timestamps are converted to it, so a
span lines up with the kernels of a profiled window as it is.  A span's
note (``note(text)``) is kept here alone.

**The profiler.**  While torch's profiler runs
(``profiler._is_profiler_enabled``: the module bool of
``torch.autograd.profiler`` that ``torch.profiler.profile`` sets), each
span is also a range of the profiler's trace under the same name, opened
and closed where the span is (``Range``, torch's
``_RecordFunctionFast``), so a profiled window holds the port's spans
beside the host's CUDA calls and the card's kernels.  A range costs the
host about a microsecond while the profiler runs; none is built while it
is off.  Both sinks may be on at once.

The boundary that runs on every call (``CapturedCall.__call__``) reads
``active`` and the profiler's bool once, and opens each of its spans in
the sinks that are on around the same statements it runs with both off;
set-up boundaries wrap their function with ``spanned(name)``, which costs
the same check, or open ``span(name)``.  With both sinks off
no span is kept, no range is built and no clock is read.  One thread
records: spans opened on another thread while a recording is open would
nest under the wrong parent.

The spans, by name:

* ``graph.call``: ``CapturedCall.__call__`` (a call of a captured graph);
  its children ``graph.copy_in`` (the copies into the static inputs, only
  where one is made) and ``graph.launch`` (the replay alone, the CUDA
  graph launch); the call's own time less theirs is the key, the lookup,
  the device switch and the counters;
* ``graph.capture``: a ``CapturedCall``'s warm-up and capture, once per
  key (in the recording a root span of the set-up; in the profiler inside
  that first call's ``graph.call``, which holds no ``graph.launch``);
* ``plan.build``: ``LargeFFTPlan``, ``OverlapSaveConv``, ``FFTPairPlan``
  and ``Channelizer``'s constructors (tables, twiddles, tuning); a
  channelizer's notes its layout and engine, "cn FusedAxisFFT" or "nc
  PallasFFTPlan(nb)"; a four-step ``LargeFFTPlan``'s where its
  inter-factor twiddle comes from and the bytes of table each call's pass
  1 reads for it, "epi device 134217728" at 4096 x 4096
  (``fused_fft.epi_table_bytes``: 8 n1 n2 from an [n1, n2] table, the
  coarse table's 4096 for "inkernel"); an ``OverlapSaveConv``'s the edges
  its chain takes (``OverlapSaveConv.edges``): "edges window cut" where
  the forward's first pass reads the signal and the inverse's last pass
  writes the output in place, "edges none" where torch's windows and cut
  run (a mesh, the single-pass engine, a lead of no whole rows);
* ``twiddle.table``: the making of that table at a plan's build:
  ``twiddle_synth.device_circle_table`` (the generator, one launch on the
  card, counted in its ``launches``), the host's ``circle_table`` or the
  coarse table's upload, noting the source, the shape and the bytes,
  "device 4096x4096 134217728", "host 256x256 524288", "inkernel 512
  4096".  The epilogue adds no launch to a call, and its bytes are no
  counter: a counter of ``graph._counters``' family is summed into the
  benchmark's ``launches_per_call`` in every cell;
* ``plan.prepare``: a prepared object made at a plan's first call with a
  key (``PreparedChain``, ``PreparedProduct``); a chain's notes how many
  of its passes form their complex products in each form of
  ``fused_fft.PRODUCT_FORMS``: exact on the int32 tile ("int32"), modulo
  2^32 there ("mod32"), modulo 2^64 on the int64 tile ("mod64") or exact
  there, in 32-bit limbs ("limb64") or in the whole form's __int128
  ("int128"), how many run on the skewed tile ("skew": a forward pass
  whose store is turned and in natural order) and, for a four-step
  plan's chain, its ``plan.build``'s "epi" note, e.g. "product int32 0
  mod32 2 mod64 0 limb64 0 int128 0 skew 1 epi device 524288" for the
  core's 64k chain (``fused_fft.products_note``); a product's the form
  of its product-sums, "p1 long long" or "p1 int128";
* ``library.load``: the kernel library's first load for a thread count,
  its ``note`` "built" or "cached";
* ``stream.repack``, ``stream.dispatch``, ``stream.wait``:
  ``StreamExecutor``'s three costs (``stats``), in the recording alone:
  they are read from its timers' clock after the fact.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.autograd import profiler

#: True while a recording is open.
on = False
#: The open ``Recording``, or None.
active = None

#: ``Range(name)``: a context manager that is a range ``name`` of the
#: profiler's trace, the kind made for hot paths; built only while
#: ``profiler._is_profiler_enabled``.
Range = torch._C._profiler._RecordFunctionFast
#: What ``span`` opens in the profiler's place while it is off.
_NO_RANGE = contextlib.nullcontext()


class Span:
    """One span; ``end_ns`` is 0 while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "note")

    def __init__(self, name, start_ns, end_ns, parent, call, note=""):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.call, self.note = parent, call, note

    def __repr__(self):
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent}, call={self.call}"
                f"{f', note={self.note!r}' if self.note else ''})")


class Recording:
    """The spans of one recording, in the order they were opened."""

    def __init__(self):
        self.spans = []
        self._stack = []
        self._calls = 0

    def add(self, name: str, start_ns: int, end_ns: int,
            parent: int | None = None, call: bool = False) -> int:
        """Record a span read on the caller's own clock reads, under
        ``parent`` (by default the innermost open span); with ``call`` it
        starts a new call.  Returns its index."""
        if parent is None:
            parent = self._stack[-1] if self._stack else -1
        if call:
            seq, self._calls = self._calls, self._calls + 1
        else:
            seq = self.spans[parent].call if parent >= 0 else -1
        self.spans.append(Span(name, start_ns, end_ns, parent, seq))
        return len(self.spans) - 1

    @contextlib.contextmanager
    def span(self, name: str):
        """A span around the block, under the innermost open one; yields
        the ``Span`` (to set its ``note``)."""
        i = self.add(name, time.time_ns(), 0)
        self._stack.append(i)
        try:
            yield self.spans[i]
        finally:
            self._stack.pop()
            self.spans[i].end_ns = time.time_ns()

    def summary(self) -> dict:
        """By span name: ``count``, ``total_ms`` and ``self_ms`` (the
        duration less the part of it that its children cover), over the
        closed spans."""
        children = {}
        for s in self.spans:
            if s.parent >= 0 and s.end_ns:
                children.setdefault(s.parent, []).append(s)
        out = {}
        for i, s in enumerate(self.spans):
            if not s.end_ns:
                continue
            covered, reach = 0, s.start_ns
            for c in sorted(children.get(i, ()), key=lambda c: c.start_ns):
                a, b = max(c.start_ns, reach), min(c.end_ns, s.end_ns)
                if b > a:
                    covered += b - a
                    reach = b
            row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                          "self_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += (s.end_ns - s.start_ns) / 1e6
            row["self_ms"] += (s.end_ns - s.start_ns - covered) / 1e6
        return out


@contextlib.contextmanager
def recording():
    """Record spans until the block ends: ``on`` is True and ``active`` the
    yielded ``Recording`` meanwhile.  Recordings do not nest."""
    global on, active
    if on:
        raise RuntimeError("a recording is open already")
    rec = Recording()
    on, active = True, rec
    try:
        yield rec
    finally:
        on, active = False, None


@contextlib.contextmanager
def span(name: str):
    """A span ``name`` around the block in each sink that is on: a range
    while the profiler runs, and in the open recording (yields its
    ``Span``, to set its note; None where no recording is open)."""
    with Range(name) if profiler._is_profiler_enabled else _NO_RANGE:
        if not on:
            yield None
            return
        with active.span(name) as s:
            yield s


def note(text: str) -> None:
    """Give the innermost open span the note ``text`` while a recording is
    open; nothing otherwise."""
    if on and active._stack:
        active.spans[active._stack[-1]].note = text


def spanned(name: str):
    """Decorate a set-up function: each call is a span ``name`` in each
    sink that is on (``span``), and costs one check of both otherwise."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (on or profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
