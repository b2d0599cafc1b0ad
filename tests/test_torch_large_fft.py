"""The 2-D scheme beyond the core's 512K (the reference's guidance for a
larger N, ``int_fftNk.vhd:12-13``) as the benchmark holds it: the plain
PyTorch four-step in blocks (``benchmark/plain/four_step.py``) equals the
frozen NumPy ``four_step_int`` and ``benchmark/plain/pair.four_step``; the
port's ``LargeFFTPlan`` equals it with its inter-factor twiddle from a
table generated on the device and synthesized in the pass; its truncating
control differs.  The cell ``fft16m_blocks_b1``'s sizes, the reader of
``epilogue_pass_roofline`` on made-up traces, and the ``twiddle.table``
span and "epi" notes of a plan's build.  The ``cuda`` tests run the
captured 16M call on the card against the eager call and the plain
reference, and read its two pass instances' registers; they skip without a
card."""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import count, manifest, reference, run
from benchmark import trace as btrace
from benchmark.builders import large_fft
from benchmark.plain import pair
from benchmark.plain.four_step import four_step_blocked
from intfftk_tpu_torch.config import FFTConfig as PortConfig
from intfftk_tpu_torch.golden import random_stimulus
from intfftk_tpu_torch.ops.fused_fft import LargeFFTPlan, fused_pass
from intfftk_tpu_torch.runtime import trace

#: the cell's transform but its size: scaled, round-half-up, 16-bit data
#: and twiddles
CORE = dict(mode="scaled", rounding="round", data_width=16, twiddle_width=16)
SIZES = [(128, 128), (256, 256)]
KINDS = ["uniform", "adversarial"]


def _frames(kind, n, seed, count_=4):
    """[count_, n] int64 frames of 16-bit samples.  "uniform": every
    sample uniform over the full scale.  "adversarial": frame 0 the
    most-negative value throughout (the guarded negates), frame 1 the top
    value throughout (a DC at full scale), frame 2 pairs (max, min) across
    the halves of the first stage's butterflies (the imaginary part the
    other way), frame 3 the round-half-up pattern (the most-negative
    value, the top one every third sample)."""
    re, im = random_stimulus(n, 16, seed=seed, batch=(count_,))
    if kind == "uniform":
        return re, im
    lo, hi = -(1 << 15), (1 << 15) - 1
    top = np.arange(n) >= n // 2
    re[0] = im[0] = lo
    re[1] = im[1] = hi
    re[2], im[2] = np.where(top, lo, hi), np.where(top, hi, lo)
    re[3] = lo
    re[3, ::3] = hi
    return re, im


def _cfg(n, **over):
    return reference.FFTConfig(**dict(CORE, n=n, **over))


def _blocked(re, im, factors, block=256, **over):
    n1, n2 = factors
    y = four_step_blocked(torch.as_tensor(re), torch.as_tensor(im),
                          _cfg(n1 * n2, **over), n1, n2, block=block)
    return [v.numpy() for v in y]


@pytest.mark.parametrize("rounding", ["round", "truncate"])
@pytest.mark.parametrize("block", [32, 100])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("factors", SIZES, ids=lambda f: f"{f[0]}x{f[1]}")
def test_blocked_equals_four_step_int(factors, kind, block, rounding):
    """At 2^14 and 2^16, in blocks of 32 and a ragged 100: bit-equal to
    the frozen ``four_step_int`` and to ``pair.four_step`` (the whole
    transform at once), under the cell's rounding and its control's."""
    n1, n2 = factors
    re, im = _frames(kind, n1 * n2, seed=n1 + block)
    got = _blocked(re, im, factors, block, rounding=rounding)
    cfg = _cfg(n1 * n2, rounding=rounding)
    want = reference.four_step_int(re, im, cfg, n1, n2)
    whole = pair.four_step(torch.as_tensor(re), torch.as_tensor(im), cfg,
                           n1, n2)
    for g, w, v in zip(got, want, whole):
        np.testing.assert_array_equal(g, np.asarray(w, dtype=np.int64))
        np.testing.assert_array_equal(g, v.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("factors", SIZES, ids=lambda f: f"{f[0]}x{f[1]}")
def test_truncating_control_differs(factors, kind):
    n1, n2 = factors
    re, im = _frames(kind, n1 * n2, seed=7)
    want = _blocked(re, im, factors)
    ctrl = _blocked(re, im, factors, rounding="truncate")
    assert sum(int(np.count_nonzero(c != w))
               for c, w in zip(ctrl, want)) > 0


def test_blocked_refuses_a_wrong_size():
    x = torch.zeros(2, 4096, dtype=torch.int64)
    with pytest.raises(ValueError, match="is not"):
        four_step_blocked(x, x, _cfg(4096), 32, 64)
    with pytest.raises(ValueError, match="frames"):
        four_step_blocked(x[:, :2048], x[:, :2048], _cfg(4096), 32, 128)
    with pytest.raises(ValueError, match="block"):
        four_step_blocked(x, x, _cfg(4096), 64, 64, block=0)


@pytest.mark.parametrize("epi", ["device", "inkernel"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("factors", [(64, 64), (256, 256)],
                         ids=lambda f: f"{f[0]}x{f[1]}")
def test_port_equals_plain_four_step(factors, kind, epi):
    """The port's plan on the CPU (the plain version of both passes), its
    inter-factor twiddle generated at build or synthesized in pass 1,
    equals the blocked reference bit for bit."""
    n1, n2 = factors
    n = n1 * n2
    plan = LargeFFTPlan(PortConfig(n=n, **CORE), n1, n2, epi_synth=epi,
                        device="cpu")
    assert plan.epi_mode == epi and plan.in_dtype == torch.int16
    re, im = _frames(kind, n, seed=n1 + 3)
    got = plan(torch.as_tensor(re), torch.as_tensor(im))
    for g, w in zip(got, _blocked(re, im, factors, block=48)):
        np.testing.assert_array_equal(g.long().numpy(), w)


def test_cell_sizes():
    """``large_fft.sizes`` of the cell's files: 16 777 216 samples a call,
    134 217 728 bytes a slot, 2 slots; the call's transforms and pass 1's
    share, each bound by its operations."""
    cell = manifest.cell("fft16m_blocks_b1")
    size = large_fft.sizes(cell.config, cell.traffic)
    assert (size.samples_per_call, size.slot_bytes, size.slots) == (
        16_777_216, 134_217_728, 2)
    assert size.ring_bytes >= count.ring_floor_bytes()
    work, epi = size.work["pass"], size.work["epilogue_pass"]
    assert (work.ops, work.bytes) == (5_033_164_800, 134_217_728)
    assert (epi.ops, epi.bytes) == (2_617_245_696, 134_217_728)
    assert round(work.bound_ms(), 5) == 0.09622
    assert round(epi.bound_ms(), 5) == 0.05003


#: kernel names as the profiler gives them: the 16M cell's pass 1 (the
#: skewed tile), its pass 2, and a skewed instance of another form
PASS1 = ("void (anonymous namespace)::fused_pass_kernel<short, short, int, "
         "false, false, 512, true, true>((anonymous namespace)::PassParams"
         "<short, short, int>)")
PASS2 = PASS1.replace("512, true, true>", "512, true, false>")
OTHER = PASS1.replace("<short, short, int, false", "<int, int, int, false")


def _read(names_ms, calls=4):
    """``epilogue_pass_roofline`` on a trace of ``names_ms`` ((name, ms)
    of each device activity, back to back) over ``calls`` calls."""
    spans, t = [], 0
    for name, ms in names_ms:
        spans.append(btrace.Span(name, t, t + int(ms * 1e6)))
        t += int(ms * 1e6) + 1000
    cell = manifest.cell("fft16m_blocks_b1")
    work = large_fft.sizes(cell.config, cell.traffic).work
    reader = manifest._reader(manifest.HERE, "epilogue_pass_roofline")
    return reader.read(run.Context(btrace.Trace(tuple(spans), ()), calls,
                                   {}, work)), work


@pytest.mark.parametrize("names, found", [
    ([PASS1, PASS2] * 4, True),
    ([PASS2] * 4, False),
    ([PASS1, PASS2, OTHER, PASS2] * 2, False),
    (["ampere_sgemm", "Memcpy DtoD"], False)],
    ids=["pass1-alone", "none-skewed", "two-skewed", "no-pass"])
def test_epilogue_reader_selects_the_skewed_instance(names, found):
    """The bound of pass 1 over the ms a call of the one instance whose
    eighth template argument is true (0.2 ms a call here); None where no
    instance or two distinct ones match."""
    value, work = _read([(n, 0.2 if n == PASS1 else 0.15) for n in names])
    if found:
        assert value == pytest.approx(
            100.0 * work["epilogue_pass"].bound_ms() / 0.2)
    else:
        assert value is None


@pytest.mark.parametrize("epi, table, shape", [
    ("host", 8 * 64 * 64, "64x64"), ("device", 8 * 64 * 64, "64x64"),
    ("inkernel", 4096, "512")])
def test_build_records_the_twiddle_source(epi, table, shape):
    """A plan built on the CPU: its ``plan.build`` notes "epi <mode>
    <bytes>", the bytes of table each call's pass 1 reads, and holds one
    ``twiddle.table`` span noting the table's source, shape and bytes."""
    with trace.recording() as rec:
        plan = LargeFFTPlan(PortConfig(n=4096, **CORE), 64, 64,
                            epi_synth=epi, device="cpu")
    assert [s.name for s in rec.spans] == ["plan.build", "twiddle.table"]
    build, made = rec.spans
    assert build.note == plan.epi_note == f"epi {epi} {table}"
    assert made.parent == 0 and made.note == f"{epi} {shape} {table}"
    assert build.start_ns <= made.start_ns <= made.end_ns <= build.end_ns


def test_monolithic_plan_notes_no_epilogue():
    with trace.recording() as rec:
        plan = LargeFFTPlan(PortConfig(n=4096, **CORE), 64, 64,
                            schedule="monolithic", device="cpu")
    assert plan.epi_note is None
    assert [(s.name, s.note) for s in rec.spans] == [("plan.build", "")]


# ------------------------------------------------------------- on the card

N16M, F16M = 1 << 24, (4096, 4096)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _device_frame(seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randint(-(1 << 15), 1 << 15, (1,) + F16M,
                               generator=gen, device=dev, dtype=torch.int16)
                 for _ in range(2))


def _plan16m(dev, **kw):
    return LargeFFTPlan(PortConfig(n=N16M, **CORE), *F16M, device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("epi", ["auto", "inkernel"])
def test_16m_capture_on_card(dev, epi):
    """The cell's plan at 2^24 = 4096 x 4096 on the card (by default the
    table generated there): the captured call equals the eager call and
    the blocked plain reference computed on the card, bit for bit, on a
    full-scale frame, two pass launches a call; a second replay on new
    inputs overwrites the static outputs.  The build and the chain note
    the twiddle's source and the table's bytes."""
    with trace.recording() as rec:
        plan = _plan16m(dev, epi_synth=epi)
        plan.apply_blocks(*_device_frame(0, dev))
    mode = "device" if epi == "auto" else epi
    table = 8 * N16M if mode == "device" else 4096
    assert plan.epi_mode == mode and not plan.fused_whole
    notes = {s.name: s.note for s in rec.spans}
    assert notes["plan.build"] == f"epi {mode} {table}"
    assert notes["twiddle.table"] == (f"device 4096x4096 {table}"
                                      if mode == "device"
                                      else f"inkernel 512 {table}")
    assert notes["plan.prepare"] == (
        f"product int32 0 mod32 2 mod64 0 limb64 0 int128 0 skew 1 "
        f"epi {mode} {table}")
    call = plan.capture()
    cfg = _cfg(N16M)
    for seed in (1, 2):
        x = _device_frame(seed, dev)
        eager = [y.clone() for y in plan.apply_blocks(*x)]
        before = fused_pass.launches
        got = call(*x)
        torch.cuda.synchronize(dev)
        assert fused_pass.launches - before == (2 if seed == 2 else 4)
        want = four_step_blocked(*(v.reshape(1, N16M) for v in x), cfg,
                                 *F16M)
        for g, e, w in zip(got, eager, want):
            assert g.dtype == torch.int16 and torch.equal(g, e)
            assert torch.equal(g.reshape(1, N16M).long(), w)


@pytest.mark.cuda
def test_16m_passes_spill_nothing(dev):
    """Pass 1 (the skewed tile, the table's epilogue) and pass 2 (the
    padded tile) of the 16M chain, as the chain prepared them: neither
    keeps a word in local memory (``intfft_pass_attributes``)."""
    plan = _plan16m(dev)
    plan.apply_blocks(*_device_frame(0, dev))
    (chain,) = plan._prepared.values()
    assert [p.skew > 0 for p in chain.passes] == [True, False]
    assert chain.products == ("mod32", "mod32")
    for p, geometry in zip(chain.passes, plan.pass_geometry):
        out = (ctypes.c_int * 5)()
        assert p.lib.intfft_pass_attributes(
            2, 2, 0, 0, 4096, geometry["lane_tile"], geometry["threads"], 0,
            1, int(p.skew > 0), 0, torch.cuda.current_device(), out) == 0
        assert out[1] == 0, tuple(out)
        assert out[4] == p.geometry[2], tuple(out)
