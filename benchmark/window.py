"""The measured window: the ring's slots replayed in turn, back to back,
each call between its own pair of CUDA events.

The host runs ahead of the card and waits only to recycle an event pair,
``POOL`` calls after it was recorded, so the card always has calls queued.
The window's rate is every sample of every call over the device time from
the first call's start event to the last call's end event: a host stall
or a slow call counts in full.  Its tail is the tail of every call's own
device time.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

#: event pairs in flight: how far the host may run ahead of the card
POOL = 512


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU (the tests): the
    host's clock when recorded."""

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def event_factory(device):
    """(a maker of timing events on ``device``, the stream they record on):
    CUDA events on the card's current stream."""
    if device.type == "cuda":
        import torch

        return (lambda: torch.cuda.Event(enable_timing=True),
                torch.cuda.current_stream(device))
    return HostEvent, None


@dataclasses.dataclass(frozen=True)
class Window:
    """Every call's device ms, in order, and the window's device ms from
    the first call's start to the last call's end."""

    call_ms: tuple
    span_ms: float

    @property
    def calls(self) -> int:
        return len(self.call_ms)

    def rate(self, samples_per_call: int) -> float:
        """Msamples/s over the whole window."""
        return samples_per_call * self.calls / self.span_ms / 1e3

    def p95(self) -> float:
        return float(np.percentile(self.call_ms, 95))

    def calls_by_slot(self, slots: int) -> list:
        """Calls of each slot: slot k ran calls k, k + R, ..."""
        return [len(range(k, self.calls, slots)) for k in range(slots)]


def run(slots, device, seconds: float | None = None,
        calls: int | None = None) -> Window:
    """Replay ``slots`` in turn for ``seconds`` of the host's clock, or for
    ``calls`` calls, each between its own events; wait for the last."""
    if (seconds is None) == (calls is None):
        raise ValueError("give seconds or calls")
    event, stream = event_factory(device)
    starts = [event() for _ in range(POOL)]
    ends = [event() for _ in range(POOL)]
    first = event()
    #: the start event of the call each pair timed last
    began = [None] * POOL
    call_ms, r = [], len(slots)
    i, deadline = 0, None
    while True:
        k = i % POOL
        if i >= POOL:
            ends[k].synchronize()
            call_ms.append(began[k].elapsed_time(ends[k]))
        began[k] = first if i == 0 else starts[k]
        began[k].record(stream)
        slots[i % r].run()
        ends[k].record(stream)
        i += 1
        if deadline is None:
            deadline = time.perf_counter() + (seconds or 0.0)
        if (i >= calls) if calls is not None else (
                time.perf_counter() >= deadline):
            break
    last = ends[(i - 1) % POOL]
    last.synchronize()
    for j in range(max(0, i - POOL), i):
        k = j % POOL
        call_ms.append(began[k].elapsed_time(ends[k]))
    return Window(call_ms=tuple(call_ms), span_ms=first.elapsed_time(last))
