"""The cell ``fft16m_blocks_b1`` (configuration ``core16m_round16``,
builder ``large_fft``; ``tests/test_torch_large_fft.py`` holds its sizes):
its metrics; the refusals of a file that does not fit the builder; a whole
run at a tiny size (n = 2^14 as 128 x 128, two frames a call) on the CPU,
correct as built, not correct with the control in place or with one output
sample changed."""

import dataclasses
import time

import pytest
import torch

from benchmark import manifest, run
from benchmark.builders import large_fft

CELL = "fft16m_blocks_b1"
SEED = (1 << 31) + 1009
CPU = torch.device("cpu")


def _tiny(slots=3, check_items=4):
    """The cell at n = 2^14 on factors 128 x 128, two frames a call, a
    ring of ``slots``."""
    cell = manifest.cell(CELL)
    config = dict(cell.config, n=1 << 14, factors=[128, 128])
    traffic = dict(cell.traffic, items_per_call=2, check_items=check_items,
                   trace_calls=2 * slots)
    one = cell.builder.sizes(config, dict(traffic, ring_bytes=1))
    traffic["ring_bytes"] = slots * one.slot_bytes
    return dataclasses.replace(cell, config=config, traffic=traffic)


def test_cell_reports_its_metrics():
    cell = manifest.cell(CELL)
    assert [n for n, _ in cell.end_to_end] == ["msamples_per_sec",
                                               "call_ms_p95", "setup_s"]
    assert [n for n, _, _ in cell.per_layer] == [
        "pass_roofline", "launches_per_call", "idle_share",
        "epilogue_pass_roofline"]


@pytest.mark.parametrize("config, traffic, match", [
    ({"direction": "inverse"}, {}, "forward"),
    ({"factors": [4096, 2048]}, {}, "factors"),
    ({}, {"amplitude_bits": 17}, "wider")])
def test_files_that_do_not_fit_are_refused(config, traffic, match):
    cell = manifest.cell(CELL)
    with pytest.raises(ValueError, match=match):
        large_fft.sizes(dict(cell.config, **config),
                        dict(cell.traffic, **traffic))


def _run(cell, **kw):
    line, numbers = run.run_cell(cell, SEED, 0.05, False, CPU,
                                 time.monotonic(), **kw)
    return line, dict((n, v) for n, v, _ in numbers)


def test_sound_run_is_correct():
    line, numbers = _run(_tiny())
    assert line["correct"] and line["failed"] == 0
    assert numbers == {"mismatched": 0, "max_gap": 0}
    assert list(line["metrics"]) == ["msamples_per_sec", "call_ms_p95",
                                     "setup_s"]


def test_control_is_not_correct():
    line, numbers = _run(_tiny(), control=True)
    assert not line["correct"]
    assert numbers["mismatched"] > 0 and numbers["max_gap"] > 0


def test_one_sample_changed_is_not_correct():
    """Sample (5, 17) of the output blocks of every call changed where it
    is produced."""
    def alter(built):
        for slot in built.slots:
            def run_(slot=slot, inner=slot.run):
                inner()
                slot.outputs[1][:, 5, 17] += 1
            slot.run = run_

    line, numbers = _run(_tiny(check_items=6), alter=alter)
    assert not line["correct"]
    assert numbers["mismatched"] > 0 and line["failed"] > 0
