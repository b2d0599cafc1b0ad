"""Fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests`` from the root of the checkout).  The harness's cells at
tiny sizes run on the CPU through the port's plain versions; tests that
need the card are marked ``cuda`` and skip here, decided in a fixture."""

import dataclasses

import pytest

#: each configuration at a tiny size with the same paths: the core on
#: 16 x 16 blocks, the convolution on four-step blocks of 64 x 128
TINY = {"core64k_round16": {"n": 256, "factors": [16, 16]},
        "conv64k_fir8193": {"n": 8192, "taps_len": 1025}}


def tiny_cell(name, slots=3, items=4, check_items=6):
    """Cell ``name`` of the manifest at a tiny size: its configuration's
    sizes from ``TINY``, ``items`` answers a call, a ring of ``slots``."""
    from benchmark import manifest

    cell = manifest.cell(name)
    config = dict(cell.config, **TINY[cell.config["name"]])
    traffic = dict(cell.traffic, items_per_call=items,
                   check_items=check_items, trace_calls=2 * slots)
    one = cell.builder.sizes(config, dict(traffic, ring_bytes=1))
    traffic["ring_bytes"] = slots * one.slot_bytes
    return dataclasses.replace(cell, config=config, traffic=traffic)


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA sm_90 card")
    return torch.device("cuda", 0)
