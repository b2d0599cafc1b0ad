"""A whole run of each cell on the CPU at a tiny size (the harness's look
for a card skipped: ``run.run_cell`` on the CPU device, the port's plain
versions in the timed path): sound runs are correct, and the control or a
fault planted underneath the timed path makes ``correct`` false.  The
result line has the contract's keys; ``main`` refuses without a card or
with a forbidden module, and prints nothing then."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import ring, run, trace

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELLS = ["fft64k_b64", "conv64k_t4"]
SEED = (1 << 31) + 977


def _run(cell, **kw):
    line, numbers = run.run_cell(cell, SEED, 0.05, False, CPU,
                                 time.monotonic(), **kw)
    return line, dict((n, v) for n, v, _ in numbers)


def _items(out, cell):
    return out.reshape(cell.traffic["items_per_call"], -1)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    cell = tiny(name)
    line, numbers = _run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["correct"] and line["failed"] == 0
    assert numbers == {"mismatched": 0, "max_gap": 0}
    assert line["attempted"] >= 3          # every slot written
    assert list(line["metrics"]) == [n for n, _ in cell.end_to_end]
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert line["compared"] == {"mismatched": {"value": 0, "limit": 0},
                                "max_gap": {"value": 0, "limit": 0}}
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    """The reference one step below the stated precision, in the
    program's place."""
    line, numbers = _run(tiny(name), control=True)
    assert not line["correct"]
    assert numbers["mismatched"] > 0 and numbers["max_gap"] > 0


def _fault_unchanged(cell):
    """Each call returns its input unchanged as its answer."""
    def alter(built):
        for slot in built.slots:
            def run_(slot=slot):
                for out, x in zip(slot.outputs, slot.inputs):
                    out.copy_(x.reshape(out.shape))
            slot.run = run_
    return alter


def _fault_half(cell):
    """Each call answers the first half of its batch and leaves the rest."""
    def alter(built):
        for slot in built.slots:
            def run_(slot=slot, inner=slot.run):
                inner()
                for out in slot.outputs:
                    rows = _items(out, cell)
                    rows[rows.shape[0] // 2:] = ring.SENTINEL
            slot.run = run_
    return alter


def _fault_altered(cell):
    """One sample of every answer altered where it is produced."""
    def alter(built):
        for slot in built.slots:
            def run_(slot=slot, inner=slot.run):
                inner()
                _items(slot.outputs[0], cell)[:, 7] += 1
            slot.run = run_
    return alter


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_half,
                                   _fault_altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny, name, fault):
    cell = tiny(name)
    line, numbers = _run(cell, alter=fault(cell))
    assert not line["correct"]
    assert numbers["mismatched"] > 0
    assert line["failed"] > 0


def test_slot_the_window_missed_is_not_correct(tiny):
    """A slot the window never wrote keeps its sentinel and reads wrong."""
    cell = tiny("fft64k_b64")

    def alter(built):
        built.slots[1].run = lambda: None

    line, _ = _run(cell, alter=alter)
    assert not line["correct"]


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "fft64k_b64", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_main_refuses_an_unknown_cell(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_main_refuses_a_forbidden_module(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: (
        {"correct": True}, [("mismatched", 0, 0)]))
    monkeypatch.setattr(run, "power_limit", lambda: "none")
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.main(["--workload", "fft64k_b64", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, the
    command prints no result and exits non-zero."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark", "--workload",
                          "fft64k_b64", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def _trace():
    S = trace.Span
    dev = (S("void fused_pass_kernel<short>", 0, 10),
           S("void (anonymous namespace)::product_kernel<int>", 12, 20),
           S("memcpy32_post", 20, 25),
           S("void at::native::elementwise_kernel<128>", 25, 28),
           S("void fused_pass_kernel<short>", 40, 50))
    host = (S("cudaGraphLaunch", 26, 45), S("window loop", 0, 60))
    return trace.Trace(dev, host)


def test_trace_reduction():
    tr = _trace()
    assert tr.window_s == pytest.approx(50e-9)
    assert tr.busy_s == pytest.approx(36e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["host: cudaGraphLaunch", pytest.approx(12e-9)]
    assert gaps[1] == ["host: window loop", pytest.approx(2e-9)]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["void fused_pass_kernel<short>",
                                  pytest.approx(20e-9)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_metric_readers_on_a_trace():
    from benchmark import count, manifest

    readers = {n.split(".")[0]: r
               for n, _, r in manifest.cell("conv64k_t4").per_layer}
    work = {"pass": count.Work(ops=0, bytes=int(3.352e12 * 10e-9)),
            "product": count.Work(ops=0, bytes=int(3.352e12 * 4e-9))}
    ctx = run.Context(_trace(), 2, {"fused_pass": 8, "spectrum_product": 2},
                      work)
    # 20 ns of pass over two calls = 10 ns a call against a 10 ns bound
    assert readers["pass_roofline"].read(ctx) == pytest.approx(100.0, 1e-3)
    assert readers["product_roofline"].read(ctx) == pytest.approx(100.0,
                                                                  1e-3)
    assert readers["glue_ms_per_call"].read(ctx) == pytest.approx(4e-6)
    assert readers["launches_per_call"].read(ctx) == 5.0
    assert readers["idle_share"].read(ctx) == pytest.approx(28.0)
    empty = run.Context(trace.Trace((), ()), 2, {}, {})
    assert all(r.read(empty) is None for r in readers.values())


@pytest.mark.cuda
def test_cell_on_the_card(card, tiny):
    """On a card: the headline cell at full size for a short window."""
    from benchmark import manifest

    line, _ = run.run_cell(manifest.cell("fft64k_b64"), 7, 0.5, False, card,
                           time.monotonic())
    assert line["correct"], json.dumps(line)
