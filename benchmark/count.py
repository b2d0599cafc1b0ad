"""The work of a call, counted from its sizes alone, and its bound.

Copied from ``bench_torch/count.py`` and frozen here: a later change to
the program cannot move the yardstick.  Bytes are each input read once and
each output written once, at the container the configuration's widths
need (int16 up to 16 bits, int32 up to 32, int64 above); operations are
12 per complex sample and stage (a butterfly stage, the inter-factor
twiddle or a pointwise product each count as one).  The bound is the
larger of bytes over the card's memory rate and operations over its
integer rate, so it reads the same work whatever implements it.
"""

from __future__ import annotations

import dataclasses

#: Device-memory rate of one NVIDIA H100 SXM (80 GB HBM3): NVIDIA's
#: published 3.35 TB/s; 3.352e12 is the card's memory clock times its bus
#: width as read on an H100 80GB HBM3 at 700 W.
BYTES_PER_S = 3.352e12
#: Integer rate of the same card.  NVIDIA publishes no CUDA-core int32
#: rate, so this is a measured ceiling: the fastest mixed chain of
#: dependent int32 operations of ``intfftk_tpu_torch/tools/probe_vpu.py``
#: on an H100 80GB HBM3 at 700 W, 52.311 T ops/s.
OPS_PER_S = 52.311e12
#: The H100's last-level (L2) cache, 50 MB as published.
L2_BYTES = 50_000_000
#: A ring of frames is at least this many times the L2 cache, so that a
#: call reads its inputs from device memory.
RING_OVER_L2 = 4
#: Operations per complex sample and stage.
OPS_PER_SAMPLE_STAGE = 12


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations and bytes of one call, or of one kernel's share of it."""

    ops: int
    bytes: int

    def __add__(self, other):
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def bound_ms(self) -> float:
        """The least time the card could take, in ms."""
        return max(self.ops / OPS_PER_S, self.bytes / BYTES_PER_S) * 1e3

    def bound_by(self) -> str:
        return ("operations" if self.ops / OPS_PER_S
                >= self.bytes / BYTES_PER_S else "bytes")


def container(width: int) -> int:
    """Bytes of the integer container a ``width``-bit value needs."""
    for size in (2, 4, 8):
        if width <= 8 * size:
            return size
    raise ValueError(f"no integer container holds {width} bits")


def stages(n: int) -> int:
    return n.bit_length() - 1


def four_step(n: int, batch: int, in_size: int, out_size: int) -> Work:
    """``batch`` n-point four-step transforms: log2(n) stages and the
    inter-factor twiddle; re and im read once at ``in_size`` bytes and
    written once at ``out_size``."""
    samples = n * batch
    return Work(samples * (stages(n) + 1) * OPS_PER_SAMPLE_STAGE,
                samples * 2 * (in_size + out_size))


def product(samples: int, in_size: int, out_size: int, table: int) -> Work:
    """A pointwise complex product of ``samples`` samples against a table
    of ``table`` int32 entries: the samples read at ``in_size`` and
    written at ``out_size``, the table read once."""
    return Work(samples * OPS_PER_SAMPLE_STAGE,
                samples * 2 * (in_size + out_size) + table * 2 * 4)


def ring_slots(slot_bytes: int, ring_bytes: int) -> int:
    """Slots of a ring of at most ``ring_bytes`` (one at the least), each
    ``slot_bytes`` of inputs and outputs."""
    return max(1, ring_bytes // slot_bytes)


def ring_floor_bytes() -> int:
    """The least a ring on the card may hold: ``RING_OVER_L2`` times the
    L2 cache."""
    return RING_OVER_L2 * L2_BYTES
