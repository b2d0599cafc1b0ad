"""Streaming block executor on CUDA streams — the WRAP/CONT protocol analog.

Counterpart of ``intfftk_tpu/runtime/stream.py:39-160``.  It accepts
arbitrary-length chunks of a channel stream, repacks them into the plan's
[n, lane_tile] tiles through a preallocated compacting buffer, keeps up to
``depth`` dispatches in flight, emits transformed blocks in order, and
splits its own costs in ``stats``.  Results appear once a full tile has
arrived; ``flush()`` pads the tail tile with zero transforms.

On a CUDA device each dispatch copies its tile into a pinned staging
slot, one of a ring of ``depth``, uploads it with ``non_blocking=True`` on
the slot's own stream, runs the plan on that stream, copies the result
back into the slot's pinned output and records an event; draining waits
on that event.  Two rules keep the asynchronous copies safe (ROADMAP
Queue A, 'runtime/stream.py'): an upload never reads the pack buffer,
which is compacted and overwritten later, only the slot's own copy of the
tile; and a slot is written again only after its event has fired, as the
ring of ``depth`` slots turns no faster than dispatches drain.  On a CPU
device the same code runs synchronously.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Iterator

import numpy as np
import torch

from ..device import resolve
from . import trace


class _Slot:
    """One staging slot: pinned int32 [n, lane_tile] tiles in and out, and
    on a CUDA device its stream and completion event."""

    def __init__(self, n: int, lane_tile: int, device: torch.device):
        cuda = device.type == "cuda"
        mk = lambda: torch.empty((n, lane_tile), dtype=torch.int32,
                                 pin_memory=cuda)
        self.in_re, self.in_im, self.out_re, self.out_im = (mk(), mk(),
                                                            mk(), mk())
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.event = torch.cuda.Event() if cuda else None

    def context(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())


class StreamExecutor:
    """Feed arbitrary-size batches of transforms through a plan.

    ``plan``: any callable (x_re, x_im) -> (y_re, y_im) over int32 [n, B]
    tiles on ``device`` (e.g. ``PallasFFTPlan(layout="nb")``); ``device``
    is the current CUDA device unless the caller names one.
    ``lane_tile``: transforms per dispatch.  Chunks are [n, c] arrays with
    any c >= 1; blocks come out as int32 numpy [n, c'] arrays."""

    def __init__(self, plan, n: int, lane_tile: int = 128, depth: int = 2,
                 device: torch.device | str | None = None):
        if lane_tile < 1 or depth < 1:
            raise ValueError(f"lane_tile {lane_tile} and depth {depth} "
                             f"must be >= 1")
        self.plan, self.n = plan, n
        self.lane_tile, self.depth = lane_tile, depth
        self.device = resolve(device)
        # compacting pack buffer: incoming chunks are copied once into
        # [n, cap]; when the write head outruns cap, the (< lane_tile)
        # unpacked remainder moves to the front
        self._cap = 4 * lane_tile
        self._buf_re = None
        self._buf_im = None
        self._rd = 0            # first unpacked column
        self._wr = 0            # first free column
        self._slots = [_Slot(n, lane_tile, self.device)
                       for _ in range(depth)]
        self._next_slot = 0
        self._inflight: collections.deque = collections.deque()
        self.reset_stats()

    def reset_stats(self):
        #: cost decomposition of the streamed contract (seconds):
        #: repack_s   host-side chunk copy into the pack buffer
        #: dispatch_s staging copy, upload, plan and download enqueue
        #: wait_s     blocking drain of finished tiles (device + link)
        self.stats = {"repack_s": 0.0, "dispatch_s": 0.0, "wait_s": 0.0,
                      "dispatches": 0, "samples_in": 0}

    def _cost(self, key: str, name: str, t0):
        """Add the time since ``t0`` to ``stats[key]``.  While a recording
        is open ``t0`` is of the spans' clock and the stretch is the span
        ``name`` too, one clock read serving both; otherwise it is of
        ``time.perf_counter()``."""
        if trace.on:
            t1 = time.time_ns()
            self.stats[key] += (t1 - t0) / 1e9
            trace.active.add(name, t0, t1)
        else:
            self.stats[key] += time.perf_counter() - t0

    # ------------------------------------------------------------ internals

    def _ensure_buf(self, dtype):
        if self._buf_re is None:
            self._buf_re = np.zeros((self.n, self._cap), dtype)
            self._buf_im = np.zeros((self.n, self._cap), dtype)

    def _append(self, xr, xi):
        c = xr.shape[1]
        if c > self._cap - self.lane_tile:
            # a chunk bigger than the buffer: grow (bounded by the
            # producer's burst size)
            self._cap = 2 * (c + self.lane_tile)
            nre = np.zeros((self.n, self._cap), self._buf_re.dtype)
            nim = np.zeros((self.n, self._cap), self._buf_im.dtype)
            keep = self._wr - self._rd
            nre[:, :keep] = self._buf_re[:, self._rd:self._wr]
            nim[:, :keep] = self._buf_im[:, self._rd:self._wr]
            self._buf_re, self._buf_im = nre, nim
            self._rd, self._wr = 0, keep
        if self._wr + c > self._cap:
            keep = self._wr - self._rd
            self._buf_re[:, :keep] = self._buf_re[:, self._rd:self._wr]
            self._buf_im[:, :keep] = self._buf_im[:, self._rd:self._wr]
            self._rd, self._wr = 0, keep
        self._buf_re[:, self._wr:self._wr + c] = xr
        self._buf_im[:, self._wr:self._wr + c] = xi
        self._wr += c

    def _dispatch(self, tile_re, tile_im, valid: int):
        t0 = time.time_ns() if trace.on else time.perf_counter()
        # the in-flight tiles hold the other depth - 1 slots: this one has
        # been drained, so its event has fired
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % self.depth
        np.copyto(slot.in_re.numpy(), tile_re)
        np.copyto(slot.in_im.numpy(), tile_im)
        if slot.stream is not None:
            # after the work already queued on the device (the plan's
            # tables among it)
            slot.stream.wait_stream(torch.cuda.current_stream(self.device))
        with slot.context():
            xr = slot.in_re.to(self.device, non_blocking=True)
            xi = slot.in_im.to(self.device, non_blocking=True)
            yr, yi = self.plan(xr, xi)
            slot.out_re.copy_(yr, non_blocking=True)
            slot.out_im.copy_(yi, non_blocking=True)
            if slot.event is not None:
                slot.event.record(slot.stream)
        self._cost("dispatch_s", "stream.dispatch", t0)
        self.stats["dispatches"] += 1
        self._inflight.append((slot, valid))

    def _drain_ready(self, force: bool = False) -> Iterator[tuple]:
        while self._inflight and (force
                                  or len(self._inflight) >= self.depth):
            slot, valid = self._inflight.popleft()
            t0 = time.time_ns() if trace.on else time.perf_counter()
            if slot.event is not None:
                slot.event.synchronize()
            yr = slot.out_re.numpy()[:, :valid].copy()
            yi = slot.out_im.numpy()[:, :valid].copy()
            self._cost("wait_s", "stream.wait", t0)
            yield yr, yi

    def _try_pack(self) -> Iterator[tuple]:
        bt = self.lane_tile
        while self._wr - self._rd >= bt:
            tile_re = self._buf_re[:, self._rd:self._rd + bt]
            tile_im = self._buf_im[:, self._rd:self._rd + bt]
            self._rd += bt
            self._dispatch(tile_re, tile_im, bt)
            yield from self._drain_ready()

    # -------------------------------------------------------------- public

    def feed(self, x_re, x_im) -> Iterator[tuple]:
        """Push a chunk [n, c]; yields any completed (re, im) blocks."""
        t0 = time.time_ns() if trace.on else time.perf_counter()
        xr = np.asarray(x_re)
        xi = np.asarray(x_im)
        if xr.ndim == 1:
            xr, xi = xr[:, None], xi[:, None]
        if xr.shape[0] != self.n:
            raise ValueError(f"chunk rows {xr.shape[0]} != n={self.n}")
        self._ensure_buf(xr.dtype)
        self._append(xr, xi)
        self._cost("repack_s", "stream.repack", t0)
        self.stats["samples_in"] += self.n * xr.shape[1]
        yield from self._try_pack()

    def flush(self) -> Iterator[tuple]:
        """Pad the tail tile with zero transforms and drain everything."""
        pending = self._wr - self._rd
        if pending:
            t0 = time.time_ns() if trace.on else time.perf_counter()
            bt = self.lane_tile
            re = np.zeros((self.n, bt), self._buf_re.dtype)
            im = np.zeros((self.n, bt), self._buf_im.dtype)
            re[:, :pending] = self._buf_re[:, self._rd:self._wr]
            im[:, :pending] = self._buf_im[:, self._rd:self._wr]
            self._rd = self._wr = 0
            self._cost("repack_s", "stream.repack", t0)
            self._dispatch(re, im, pending)
        yield from self._drain_ready(force=True)
