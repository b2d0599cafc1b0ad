"""The cell ``c2_unscaled32_b8`` (configuration ``pair64k_unscaled32``,
builder ``fft_pair``): its sizes and work from its files alone; its
frames, which stay in 32 bits and drive the forward's peak bin past 2^45;
the reader of ``inverse_pass_roofline`` on kernel names as the profiler
records them; a whole run at a tiny size on the CPU, correct as built,
not correct with the control in place or with one output sample
changed."""

import dataclasses
import time

import pytest
import torch

from benchmark import count, manifest, run, trace
from benchmark.builders import fft_pair
from benchmark.plain import pair as plain

CELL = "c2_unscaled32_b8"
MiB = 1 << 20
SEED = (1 << 31) + 977
CPU = torch.device("cpu")


def _cell():
    return manifest.cell(CELL)


def _tiny(slots=3, items=4, check_items=6):
    """The cell at 4096 points (64 x 64, the product at the forward's 44
    bits), ``items`` frames a call, a ring of ``slots``."""
    cell = _cell()
    config = dict(cell.config, n=4096, factors=[64, 64])
    traffic = dict(cell.traffic, items_per_call=items,
                   check_items=check_items, trace_calls=2 * slots)
    one = cell.builder.sizes(config, dict(traffic, ring_bytes=1))
    traffic["ring_bytes"] = slots * one.slot_bytes
    return dataclasses.replace(cell, config=config, traffic=traffic)


def test_sizes_and_work():
    """8 frames of 64k a call; int32 in and int64 out, 12 MiB a slot, 21
    slots; the forward from 32-bit data to the 48-bit spectrum, the
    inverse 48 to 48, P1 48 to 48 against the 64k table."""
    cell = _cell()
    size = cell.builder.sizes(cell.config, cell.traffic)
    n, b = 65536, 8
    assert size.samples_per_call == b * n == 524288
    assert size.slot_bytes == b * n * 2 * (4 + 8) == 12 * MiB
    assert size.slots == 21 and size.ring_bytes >= count.ring_floor_bytes()
    assert set(size.work) == {"pass", "inverse_pass", "product"}
    inverse = count.four_step(n, b, 8, 8)
    assert size.work["pass"] == count.four_step(n, b, 4, 8) + inverse
    assert size.work["inverse_pass"] == inverse
    assert size.work["product"] == count.product(b * n, 8, 8, n)
    assert size.work["pass"].ops == 2 * b * n * 17 * 12
    assert size.work["product"].bytes == b * n * 2 * 16 + n * 8


def test_cell_reports_the_card_bound_metrics():
    cell = _cell()
    assert cell.chips == 1
    assert [n for n, _ in cell.end_to_end] == ["msamples_per_sec",
                                               "call_ms_p95", "setup_s"]
    assert [n for n, _, _ in cell.per_layer] == [
        "pass_roofline", "product_roofline", "launches_per_call",
        "idle_share", "inverse_pass_roofline"]


def test_spectrum_is_a_unit_all_pass_within_its_width():
    hr, hi = fft_pair.spectrum(_cell().config)
    assert hr.shape == hi.shape == (65536,)
    lim = 1 << 24                                  # 25 bits
    assert -lim <= min(hr.min(), hi.min()) and max(hr.max(), hi.max()) < lim
    mag = (hr.astype(float) ** 2 + hi.astype(float) ** 2) ** 0.5
    assert abs(mag / 2 ** 23 - 1).max() < 1e-6
    assert (hr[0], hi[0]) == (1 << 23, 0)


@pytest.mark.parametrize("seed", [SEED, 5, 4_000_000_003])
def test_frames_stay_in_32_bits_and_drive_the_peak_bin(seed):
    """Each frame fits 32 bits, and the magnitude of the forward's largest
    bin reaches 2^45 or more (a carrier of 2^30 summed over 2^16 samples,
    at most 3.9 dB lost where it falls between two bins), each part under
    the 48-bit spectrum's 2^47."""
    config = _cell().config
    cfg, _ = fft_pair.reference_configs(config)
    xr, xi = fft_pair.tone_frames(2, 65536, _cell().traffic, seed, CPU)
    assert max(xr.abs().max(), xi.abs().max()) < 1 << 31
    fr, fi = plain.four_step(xr, xi, cfg, *config["factors"])
    peak = (fr.double() ** 2 + fi.double() ** 2).sqrt().amax(dim=-1)
    assert (peak >= 2.0 ** 45).all()
    assert max(fr.abs().max(), fi.abs().max()) < 1 << 47


def test_frames_come_from_the_seed():
    traffic = _cell().traffic
    a = fft_pair.tone_frames(2, 1024, traffic, SEED, CPU)
    b = fft_pair.tone_frames(2, 1024, traffic, SEED, CPU)
    c = fft_pair.tone_frames(2, 1024, traffic, SEED + 1, CPU)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])


#: the kernels of the cell's traced chip run (H100 80GB HBM3, torch 2.11,
#: CUDA 12.8), as the profiler named them, and whether each is an inverse
#: pass; then forms the parser must also read
_ARGS = ("const*, {0} const*, int const*, int const*, int const*, "
         "int const*, int const*, int const*, int const*, int const*, "
         "long*, long*, intfft::PassParams, intfft::SynthParams)")
NAMES = [
    ("void (anonymous namespace)::fused_pass_kernel<long, long, long, true, "
     "false, 256, false>(long " + _ARGS.format("long"), True),
    ("void (anonymous namespace)::fused_pass_kernel<int, long, long, false, "
     "false, 256, true>(int " + _ARGS.format("int"), False),
    ("void (anonymous namespace)::fused_pass_kernel<long, long, long, false, "
     "false, 256, true>(long " + _ARGS.format("long"), False),
    ("void (anonymous namespace)::product_kernel<long, long, __int128, 2>("
     "long const*, long const*, int const*, int const*, long*, long*, "
     "unsigned long, unsigned long, int, int)", False),
    ("void (anonymous namespace)::fused_pass_kernel<short, short, int, "
     "false, false, 128, false>", False),
    ("void fused_pass_kernel<Box<int, 2>, long, long, true>", True),
    ("void (anonymous namespace)::fused_whole_kernel<long, long, long, "
     "true>", False),
]


@pytest.mark.parametrize("name, inverse", NAMES)
def test_inverse_pass_reader_parses_templates(name, inverse):
    reader = manifest._reader(manifest.HERE, "inverse_pass_roofline")
    assert reader.inverse(name) is inverse


def test_inverse_pass_reader_on_a_trace():
    reader = manifest._reader(manifest.HERE, "inverse_pass_roofline")
    S = trace.Span
    dev = (S(NAMES[0][0], 0, 10), S(NAMES[1][0], 10, 40),
           S(NAMES[3][0], 40, 45), S(NAMES[0][0], 50, 60))
    work = {"inverse_pass": count.Work(ops=0,
                                       bytes=int(3.352e12 * 10e-9))}
    ctx = run.Context(trace.Trace(dev, ()), 2, {"fused_pass": 8}, work)
    # 20 ns of inverse pass over two calls against a 10 ns bound
    assert reader.read(ctx) == pytest.approx(100.0, 1e-3)
    assert reader.read(run.Context(trace.Trace(dev[1:3], ()), 2, {},
                                   work)) is None
    assert reader.read(run.Context(trace.Trace(dev, ()), 2, {}, {})) is None


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
    """One output sample of one frame of every call changed where it is
    produced (every answer checked)."""
    cell = _tiny(check_items=12)

    def alter(built):
        for slot in built.slots:
            def run_(slot=slot, inner=slot.run):
                inner()
                slot.outputs[1].view(-1)[4096 + 17] += 1
            slot.run = run_

    line, numbers = _run(cell, alter=alter)
    assert not line["correct"]
    assert numbers["mismatched"] > 0 and line["failed"] > 0


def test_a_slot_the_window_missed_is_not_correct():
    cell = _tiny(check_items=12)

    def alter(built):
        built.slots[2].run = lambda: None

    line, _ = _run(cell, alter=alter)
    assert not line["correct"]
