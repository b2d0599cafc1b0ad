"""The work of each cell, counted from its shapes alone, and its bound.

The benchmark's own copy of the formulas of
``intfftk_tpu_torch/utils/roofline.py`` (``large_fft_cost``, ``fft_cost``):
bytes are each input read once and each output written once; operations
are 12 per sample and stage (a stage, an inter-factor twiddle or a
pointwise product each count as one).  The bound is the larger of bytes
over the card's memory rate and operations over its integer rate, so it
reads the same work whatever implements it.  The two rates are fixed here:
a later change to the program cannot move them.
"""

from __future__ import annotations

import dataclasses

#: device-memory rate of an NVIDIA H100 80GB HBM3 at 700.00 W: its memory
#: clock x bus width, as chip_smoke.py read it (PERF.md section 5)
BYTES_PER_S = 3.352e12
#: integer rate of the same card: the better mixed op chain of
#: tools/probe_vpu.py, as chip_smoke.py measured it (PERF.md section 5)
OPS_PER_S = 52.311e12
#: operations per complex sample and stage (roofline.OPS_PER_SAMPLE_STAGE)
OPS_PER_SAMPLE_STAGE = 12


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations and bytes of one call of a cell."""

    ops: int
    bytes: int

    def __add__(self, other):
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def bound(self) -> tuple[float, str]:
        """(least ms the card could take, "operations" or "bytes")."""
        ops_s, bytes_s = self.ops / OPS_PER_S, self.bytes / BYTES_PER_S
        return (max(ops_s, bytes_s) * 1e3,
                "operations" if ops_s >= bytes_s else "bytes")


def stages(n: int) -> int:
    return n.bit_length() - 1


def single_pass(n: int, batch: int, itemsize: int = 4) -> Work:
    """A batch of n-point transforms in one pass (``fft_cost``): log2(n)
    stages; re and im read and written once."""
    samples = n * batch
    return Work(samples * stages(n) * OPS_PER_SAMPLE_STAGE,
                samples * 2 * itemsize * 2)


def four_step(n: int, batch: int, in_size: int = 2,
              out_size: int | None = None) -> Work:
    """A batch of n-point four-step transforms (``large_fft_cost``):
    log2(n) stages and the inter-factor twiddle; re and im read once at
    ``in_size`` bytes and written once at ``out_size``."""
    samples = n * batch
    out_size = in_size if out_size is None else out_size
    return Work(samples * (stages(n) + 1) * OPS_PER_SAMPLE_STAGE,
                samples * 2 * (in_size + out_size))


def products(samples: int, table: int) -> Work:
    """A pointwise product of ``samples`` complex samples against an int32
    table of ``table`` entries, read once; the data's bytes are the
    caller's."""
    return Work(samples * OPS_PER_SAMPLE_STAGE, table * 2 * 4)


def moved(samples: int, in_size: int, out_size: int) -> Work:
    """Only bytes: re and im of ``samples`` read at ``in_size`` and written
    at ``out_size``."""
    return Work(0, samples * 2 * (in_size + out_size))


def config2(n: int, batch: int) -> Work:
    """The config-2 chain: the forward, the product and the inverse as one
    function: int32 in, int64 out, the [n] table read once."""
    inner = four_step(n, batch, 0, 0)
    return (inner + inner + products(n * batch, n)
            + moved(n * batch, 4, 8))


def config4(n: int, blocks: int, payload_samples: int) -> Work:
    """Overlap-save: per block of n a forward, the product and an inverse;
    the int32 signal in, the int64 payload out, the taps table once."""
    inner = four_step(n, blocks, 0, 0)
    return (inner + inner + products(n * blocks, n)
            + moved(payload_samples, 4, 8))
