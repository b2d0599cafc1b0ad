"""The cells ``c3_channelizer_cn`` and ``c3_channelizer_nc`` (configuration
``chan4096_fft4k_round16``, builder ``channelizer``): their sizes and work
from their files alone; the refusals of a file that does not fit the
builder; a whole run at a tiny size on the CPU, correct as built, not
correct with the control in place or with one output sample changed."""

import dataclasses
import time

import pytest
import torch

from benchmark import count, manifest, run
from benchmark.builders import channelizer

CELLS = ("c3_channelizer_cn", "c3_channelizer_nc")
SEED = (1 << 31) + 977
CPU = torch.device("cpu")


def _tiny(name, slots=3, check_items=24):
    """The cell at n = 256 on a bank of 64 channels, a ring of
    ``slots``."""
    cell = manifest.cell(name)
    config = dict(cell.config, n=256, channels=64)
    traffic = dict(cell.traffic, items_per_call=64, check_items=check_items,
                   trace_calls=2 * slots)
    one = cell.builder.sizes(config, dict(traffic, ring_bytes=1))
    traffic["ring_bytes"] = slots * one.slot_bytes
    return dataclasses.replace(cell, config=config, traffic=traffic)


@pytest.mark.parametrize("name", CELLS)
def test_sizes_and_work(name):
    """A bank of 4096 channels of 4096 samples a call; int32 in and out,
    256 MiB a slot, 2 slots; 12 stages and no inter-factor twiddle, bytes
    at the 16-bit widths' containers; bound by its operations."""
    cell = manifest.cell(name)
    assert cell.chips == 1
    size = cell.builder.sizes(cell.config, cell.traffic)
    assert size.samples_per_call == 4096 * 4096
    assert size.slot_bytes == 4096 * 4096 * 2 * (4 + 4) == 268_435_456
    assert size.slots == 2 and size.ring_bytes >= count.ring_floor_bytes()
    work = size.work["pass"]
    assert set(size.work) == {"pass"}
    assert (work.ops, work.bytes) == (2_415_919_104, 134_217_728)
    assert work.bound_by() == "operations"
    assert work.bound_ms() == pytest.approx(0.046184, abs=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_the_card_bound_metrics(name):
    cell = manifest.cell(name)
    assert cell.traffic["layout"] == name[-2:]
    assert [n for n, _ in cell.end_to_end] == ["msamples_per_sec",
                                               "call_ms_p95", "setup_s"]
    assert [n for n, _, _ in cell.per_layer] == [
        "pass_roofline", "launches_per_call", "idle_share"]


@pytest.mark.parametrize("config, traffic, match", [
    ({"direction": "inverse"}, {}, "forward"),
    ({}, {"layout": "bn"}, "bad layout"),
    ({}, {"items_per_call": 2048}, "bank of 4096"),
    ({}, {"amplitude_bits": 17}, "wider"),
    ({"mode": "unscaled", "data_width": 24}, {}, "int32")])
def test_files_that_do_not_fit_are_refused(config, traffic, match):
    cell = manifest.cell(CELLS[0])
    with pytest.raises(ValueError, match=match):
        channelizer.sizes(dict(cell.config, **config),
                          dict(cell.traffic, **traffic))


def _run(cell, **kw):
    line, numbers = run.run_cell(cell, SEED, 0.05, False, CPU,
                                 time.monotonic(), **kw)
    return line, dict((n, v) for n, v, _ in numbers)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line, numbers = _run(_tiny(name))
    assert line["correct"] and line["failed"] == 0
    assert numbers == {"mismatched": 0, "max_gap": 0}
    assert list(line["metrics"]) == ["msamples_per_sec", "call_ms_p95",
                                     "setup_s"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    line, numbers = _run(_tiny(name), control=True)
    assert not line["correct"]
    assert numbers["mismatched"] > 0 and numbers["max_gap"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_one_sample_changed_is_not_correct(name):
    """Sample 17 of every channel of every call changed where it is
    produced: a column of the [C, n] bank, a row of the [n, C] one."""
    cell = _tiny(name, check_items=6)
    sample = (slice(None), 17) if cell.traffic["layout"] == "cn" else 17

    def alter(built):
        for slot in built.slots:
            def run_(slot=slot, inner=slot.run):
                inner()
                slot.outputs[1][sample] += 1
            slot.run = run_

    line, numbers = _run(cell, alter=alter)
    assert not line["correct"]
    assert numbers["mismatched"] > 0 and line["failed"] > 0
