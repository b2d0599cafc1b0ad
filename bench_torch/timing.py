"""Device timing of chained calls on the card, with CUDA events.

Every function here takes ``fn``, a call (a, b) -> (a', b') whose output
feeds the next call (the way the reference's benchmark chains K calls in
one ``jit(scan)``), and its first inputs on the card.  Each raises
RuntimeError when CUDA is not available or an input lies elsewhere: a
device time is never taken on the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

#: chained calls in one reading, where a caller names none
CHAIN = 50
#: individually timed readings of ``readings``, where a caller names none
READINGS = 40


def require_cuda(*xs):
    """Raise RuntimeError unless CUDA is available and every tensor of
    ``xs`` (None is skipped) lies on a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: device times are taken on the "
                           "card only (python -m bench_torch --smoke checks "
                           "bits and counts on the CPU)")
    for x in xs:
        if x is not None and not x.is_cuda:
            raise RuntimeError(f"a timed input lies on {x.device}, not on "
                               f"the card")


def event_ms(fn, xr, xi, calls=CHAIN, warmup=3):
    """Mean device time of one call of a chained xr, xi -> fn(xr, xi)."""
    import torch

    require_cuda(xr, xi)
    for _ in range(warmup):
        xr, xi = fn(xr, xi)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        xr, xi = fn(xr, xi)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def paced(fn, xr, xi, calls=CHAIN):
    """(device ms, host ms) per call of a chained fn: the time between two
    CUDA events around ``calls`` calls, and the host's clock from the first
    call to the return of the last, before any wait.  Where the two agree
    the card ran each call as it arrived and the host sets the pace; where
    the host is done long before the card, the card does."""
    import torch

    require_cuda(xr, xi)
    for _ in range(3):
        xr, xi = fn(xr, xi)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        xr, xi = fn(xr, xi)
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, host * 1e3 / calls


def _chained_graph(fn, xr, xi, calls):
    """A ``CapturedCall`` of ``calls`` chained calls of fn, warmed up and
    captured on (xr, xi), and its static inputs."""
    from intfftk_tpu_torch.runtime import captured

    def chained(a, b):
        for _ in range(calls):
            a, b = fn(a, b)
        return a, b

    call = captured(chained)
    call(xr, xi)                          # warm-up, capture, one replay
    return call, call.static_inputs(xr, xi)


def captured_ms(fn, xr, xi, calls=CHAIN, replays=3):
    """Mean device time of one call of a chained fn, read from one CUDA
    graph of ``calls`` chained calls (``runtime.graph.captured``) replayed
    ``replays`` times on its static inputs: the card's own time for the
    path, with no host between the calls."""
    import torch

    require_cuda(xr, xi)
    call, static = _chained_graph(fn, xr, xi, calls)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        call(*static)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def replayed(fn, xr, xi):
    """The outputs of one call of fn as a CUDA graph replays it: the call
    captured on (xr, xi) as the timed readings capture their chain, then
    replayed twice, the second time on its inputs copied in anew; clones
    of the second replay's outputs.  What a cell checks is what its timed
    graph computes."""
    require_cuda(xr, xi)
    call, _ = _chained_graph(fn, xr, xi, 1)
    return tuple(t.clone() for t in call(xr, xi))


@dataclasses.dataclass(frozen=True)
class Readings:
    """Individually timed readings of one call, in ms: ``window``, the
    whole window's device time per call (from the first reading's start
    to the last one's end, over every call of every reading), and the
    readings' median, their 75th percentile (the slower quarter begins
    there; with 40 readings ten lie beyond it) and their count."""

    values: tuple
    window: float

    @property
    def median(self) -> float:
        return float(np.median(self.values))

    @property
    def p75(self) -> float:
        return float(np.percentile(self.values, 75))

    @property
    def count(self) -> int:
        return len(self.values)

    def summary(self) -> dict:
        return {"window": self.window, "median": self.median,
                "p75": self.p75, "count": self.count}

    def rate(self, samples: int) -> float:
        """Msamples/s of ``samples`` per call over the whole window: every
        sample of every reading over all of its device time."""
        return samples / self.window / 1e3

    def rates(self, samples: int) -> dict:
        """Msamples/s of ``samples`` per call at the median reading and at
        the p75 reading (the slower one), and the count."""
        return {"median": samples / self.median / 1e3,
                "p75": samples / self.p75 / 1e3, "count": self.count}


def readings(fn, xr, xi, calls=CHAIN, count=READINGS, capture=True):
    """``count`` readings of one call of a chained fn, each the device time
    of ``calls`` chained calls over ``calls``, between two CUDA events, and
    the window they span.
    ``capture=True``: each reading is one replay of one CUDA graph of the
    ``calls`` calls (captured once, after a warm-up that builds, grants and
    prepares); ``False``: the calls are issued eagerly, for a path with no
    capture that the card paces."""
    import torch

    require_cuda(xr, xi)
    if capture:
        call, static = _chained_graph(fn, xr, xi, calls)
        step = lambda: call(*static)
    else:
        state = [xr, xi]

        def step():
            for _ in range(calls):
                state[:] = fn(*state)

        step()                            # warm-up
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(count)]
    for start, end in pairs:
        start.record()
        step()
        end.record()
    torch.cuda.synchronize()
    return Readings(tuple(s.elapsed_time(e) / calls for s, e in pairs),
                    pairs[0][0].elapsed_time(pairs[-1][1]) / (count * calls))
