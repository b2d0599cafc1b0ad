"""The ring of frames a cell's window replays, and the seeds its data
comes from.

A cell holds R slots on the device, each with inputs of its own and the
outputs its call writes.  R is as many slots as the traffic's
``ring_bytes`` holds (``count.ring_slots``), and on the card the ring's
inputs and outputs together must be at least four times its L2 cache
(``count.ring_floor_bytes``): each call reads a frame that the previous
calls evicted, as a real pipeline's next frame comes from device memory.

On the card each slot is one CUDA graph, captured around one call of the
program's entry through the program's own ``capture()``: the slot's
inputs are the graph's static inputs and its outputs the graph's static
outputs, so a replay copies nothing.  On the CPU (the tests) a slot calls
the plain version and copies its answer into outputs of its own, which
stand in for a graph's static outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

#: What every output is filled with before a window, so that a slot the
#: window did not write reads wrong.
SENTINEL = 0x5A5A


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the part named ``keys`` of the run seeded by
    ``seed`` (any whole number): every part of a run draws from its own
    stream, the same for the same seed."""
    words = [seed % (1 << 64)] + [
        int.from_bytes(str(k).encode(), "little") for k in keys]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


def uniform(shape, bits: int, dtype: torch.dtype, seed: int,
            device: torch.device) -> torch.Tensor:
    """Integers uniform in [-2^(bits-1), 2^(bits-1)), made on ``device`` by
    a generator of its own seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lim = 1 << (bits - 1)
    return torch.randint(-lim, lim, tuple(shape), generator=gen,
                         device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """A cell's sizes from its files alone: the samples one call counts,
    the bytes of one slot's inputs and outputs, the ring's slots, and the
    work of one call of each kernel family whose roofline a metric reads
    (``"pass"``, ``"product"``)."""

    samples_per_call: int
    slot_bytes: int
    slots: int
    work: dict

    @property
    def ring_bytes(self) -> int:
        return self.slots * self.slot_bytes


@dataclasses.dataclass
class Slot:
    """One frame of the ring: ``run()`` is one call on ``inputs``, whose
    answer lies in ``outputs`` afterwards."""

    run: Callable[[], object]
    inputs: tuple
    outputs: tuple


def make_slot(capture: Callable, plain: Callable, inputs: tuple,
              device: torch.device) -> Slot:
    """A slot answering ``inputs``.  On the card ``capture()`` is a fresh
    captured call of the program's entry (``plan.capture()``): its first
    call warms up, captures and replays; its static inputs then are the
    slot's inputs.  On the CPU ``plain`` is the entry itself."""
    if device.type == "cuda":
        call = capture()
        outputs = tuple(call(*inputs))
        static = call.static_inputs(*inputs)
        return Slot(lambda: call(*static), static, outputs)
    outputs = tuple(t.clone() for t in plain(*inputs))

    def run():
        for out, y in zip(outputs, plain(*inputs)):
            out.copy_(y)

    return Slot(run, inputs, outputs)


def fill_sentinel(slots) -> None:
    for slot in slots:
        for out in slot.outputs:
            out.fill_(SENTINEL)


@dataclasses.dataclass
class Compared:
    """What the check compared: the answers it read, the values that
    differ from the reference, the widest gap, and the slots whose
    answers differ."""

    answers: int = 0
    mismatched: int = 0
    max_gap: int = 0
    bad_slots: set = dataclasses.field(default_factory=set)

    def add(self, slot: int, got, want) -> None:
        got = [np.asarray(v, dtype=np.int64) for v in got]
        want = [np.asarray(v, dtype=np.int64) for v in want]
        self.answers += got[0].shape[0]
        for g, w in zip(got, want):
            if g.shape != w.shape:
                raise ValueError(f"answer shape {g.shape} != reference "
                                 f"{w.shape}")
            bad = int(np.count_nonzero(g != w))
            if bad:
                self.mismatched += bad
                self.max_gap = max(self.max_gap, int(np.abs(g - w).max()))
                self.bad_slots.add(slot)


def draw(seed: int, slots: int, per_slot: int, wanted: int):
    """``wanted`` distinct (slot, index) pairs of a ring of ``slots`` slots
    with ``per_slot`` answers each, drawn from the seed, by slot."""
    rng = np.random.default_rng(sub_seed(seed, "check"))
    total = slots * per_slot
    picks = rng.choice(total, size=min(wanted, total), replace=False)
    by_slot = {}
    for p in sorted(int(p) for p in picks):
        by_slot.setdefault(p // per_slot, []).append(p % per_slot)
    return by_slot


@dataclasses.dataclass
class Built:
    """A cell built on a device: its ring of slots, its sizes, and
    ``check(seed, control)``, which compares a sample of the answers in
    the ring (drawn from the seed) with the reference and returns a
    ``Compared``; with ``control`` the control's answers stand in the
    program's place."""

    slots: list
    sizes: Sizes
    check: Callable[[int, bool], Compared]
