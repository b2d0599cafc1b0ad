"""The harness finds a cell, a traffic mix, a configuration and a
per-layer metric by name, from files added beside the others, with no
file that exists edited; and refuses unknown names and names outside the
driver's character set."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import manifest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def tree(tmp_path):
    """A copy of the manifest and of benchmark/ (tests and caches left
    out), with the original files' contents recorded."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    return tmp_path, before


def _add(root):
    """A new mix, cell and metric: new files, and entries appended to the
    manifest."""
    (root / "benchmark" / "traffic" / "frames_b16.json").write_text(
        json.dumps({"submission": "closed loop", "items_per_call": 16,
                    "amplitude_bits": 16, "ring_bytes": 1 << 28,
                    "check_items": 8, "trace_calls": 10}))
    (root / "benchmark" / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "fft64k_b16", "config": "core64k_round16",
                           "traffic": "frames_b16", "chips": 1,
                           "why": "a new cell"})
    m["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "plan", "moves": "msamples_per_sec",
                           "workloads": ["fft64k_b16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))


def test_new_files_are_found_without_edits(tree):
    root, before = tree
    _add(root)
    cell = manifest.cell("fft64k_b16", root)
    assert cell.traffic["items_per_call"] == 16
    assert cell.config["name"] == "core64k_round16"
    names = [n for n, _, _ in cell.per_layer]
    assert "calls_traced" in names and "product_roofline" not in names
    reader = dict((n, r) for n, _, r in cell.per_layer)["calls_traced"]
    assert reader.read(type("Ctx", (), {"calls": 3})()) == 3.0
    size = cell.builder.sizes(cell.config, cell.traffic)
    assert size.samples_per_call == 16 * 65536
    # no file of the copy other than the manifest changed
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == [root / "BENCHMARK.json"]
    # every cell of the original manifest still parses
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        assert manifest.cell(w["name"], root).name == w["name"]


def test_split_quantities_share_a_reader():
    """``pass_roofline`` and ``pass_roofline.small_calls`` read alike;
    every cell reports setup_s, another end-to-end metric, and each
    per-layer metric's ``moves``."""
    m = manifest.load()
    for w in m["workloads"]:
        cell = manifest.cell(w["name"])
        e2e = [n for n, _ in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        for name, _, reader in cell.per_layer:
            assert reader.__name__ == (
                "benchmark_metric_" + name.split(".")[0])
            moves = next(p["moves"] for p in m["per_layer"]
                         if p["name"] == name)
            assert moves in e2e


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", ".hidden", "-x",
                                 "x" * 65, "café", "muµs"])
def test_names_outside_the_set_are_refused(tree, bad):
    root, _ = tree
    with pytest.raises(manifest.ManifestError):
        manifest.check_name("cell", bad)
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"][0]["traffic"] = bad
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    with pytest.raises(manifest.ManifestError):
        manifest.load(root)


@pytest.mark.parametrize("good", ["a", "_x", "9b", "fft64k_b64",
                                  "dispatch_ms.train", "x-y", "x" * 64])
def test_names_inside_the_set_pass(good):
    assert manifest.check_name("cell", good) == good


def test_unknown_pieces_are_refused(tree):
    root, _ = tree
    with pytest.raises(manifest.ManifestError, match="no cell"):
        manifest.cell("no_such_cell", root)
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "ghost", "config": "core64k_round16",
                           "traffic": "no_such_mix", "chips": 1, "why": "x"})
    m["workloads"].append({"name": "orphan", "config": "no_such_config",
                           "traffic": "frames_b8", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "no_reader", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "plan", "moves": "msamples_per_sec",
                           "workloads": ["fft64k_b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    with pytest.raises(manifest.ManifestError, match="traffic"):
        manifest.cell("ghost", root)
    with pytest.raises(manifest.ManifestError, match="configuration"):
        manifest.cell("orphan", root)
    with pytest.raises(manifest.ManifestError, match="no file"):
        manifest.cell("fft64k_b8", root)


def test_two_cells_of_one_name_are_refused(tree):
    root, _ = tree
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append(dict(m["workloads"][0]))
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    with pytest.raises(manifest.ManifestError, match="two cells"):
        manifest.load(root)
