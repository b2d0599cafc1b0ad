"""Nothing under ``benchmark/`` imports jax, the JAX package or the port's
older benchmark, and the reference imports nothing of the port; top-level
names are compared whole (``intfftk_tpu_torch`` is not ``intfftk_tpu``)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "intfftk_tpu", "bench_torch"}
#: what the reference may import besides itself
REFERENCE_MAY = {"numpy", "math", "dataclasses", "typing", "__future__"}
FILES = sorted(HERE.rglob("*.py"))


def _imports(path):
    """Top-level names of every absolute import in ``path``, at any
    depth of the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not set(_imports(path)) & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_numpy_alone(path):
    assert set(_imports(path)) <= REFERENCE_MAY, path


def _fresh(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


def test_fresh_process_holds_nothing_forbidden():
    """The harness, every cell's builder and metric readers, and the port
    they import (as a run on the CPU would), in a fresh process."""
    tops = _fresh(
        "import json, sys\n"
        "import benchmark.run\n"
        "from benchmark import manifest\n"
        "import intfftk_tpu_torch, intfftk_tpu_torch.golden\n"
        "for w in manifest.load()['workloads']:\n"
        "    manifest.cell(w['name'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "intfftk_tpu_torch" in tops
    assert not set(tops) & FORBIDDEN


def test_reference_alone_holds_no_port():
    tops = _fresh(
        "import json, sys\n"
        "import benchmark.reference\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not set(tops) & (FORBIDDEN | {"intfftk_tpu_torch", "torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run

    base = set(run.forbidden_modules()) - {"intfftk_tpu"}
    monkeypatch.setitem(sys.modules, "intfftk_tpu_torch_shadow", sys)
    monkeypatch.setitem(sys.modules, "intfftk_tpu_torch.ops", sys)
    assert set(run.forbidden_modules()) - base <= {"intfftk_tpu"}
    if "intfftk_tpu" not in sys.modules:
        assert "intfftk_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "intfftk_tpu.ops", sys)
    assert set(run.forbidden_modules()) == base | {"intfftk_tpu"}
