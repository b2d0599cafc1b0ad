"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names every cell (a
configuration under a traffic mix), every end-to-end and per-layer metric
and every configuration.  Each piece is a file of its own under
``benchmark/``, found by its name there:

* a configuration: the ``file`` its entry gives (``configs/<name>.json``),
  which names a builder, ``builders/<builder>.py``;
* a traffic mix: ``traffic/<name>.json``, parameters that the ring
  generator of ``ring.py`` and the builder read;
* a per-layer metric: ``metrics/<name>.py``, a reader with ``read(ctx)``;
  a quantity split by the cells' end-to-end metric (``pass_roofline`` and
  ``pass_roofline.small_calls``) may share the reader of its name before
  the first dot.

A later change adds a cell, a mix, a configuration or a metric as new
files and entries, without editing a file that exists.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

#: The benchmark's own directory, and the checkout's root above it.
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: A name: a letter, digit or _ first, then at most 63 of letters, digits,
#: _, . and - (no space, comma or slash).
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


class ManifestError(ValueError):
    """The manifest or a file it names is missing or malformed."""


def check_name(kind: str, name) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ManifestError(f"bad {kind} name {name!r}: 1-64 of A-Z a-z 0-9 "
                            f"_ . -, not starting with . or -")
    return name


def _read_json(path: Path, what: str) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise ManifestError(f"{what}: no file {path}") from None
    except json.JSONDecodeError as e:
        raise ManifestError(f"{what}: {path} is not JSON: {e}") from None


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise ManifestError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell as the manifest and its files give it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    #: the builder's module: ``sizes(config, traffic)`` and ``build(...)``
    builder: object
    #: (name, unit) of each end-to-end metric it reports, in the
    #: manifest's order
    end_to_end: tuple
    #: (name, unit, reader module) of each per-layer metric it reports
    per_layer: tuple


def _reader(here: Path, metric: str):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``,
    else that of its name before the first dot."""
    path = here / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = here / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, f"benchmark_metric_{path.stem}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` of ``root``, with every name checked."""
    manifest = _read_json(root / "BENCHMARK.json", "the manifest")
    for key, kind in (("configs", "configuration"), ("workloads", "cell"),
                      ("end_to_end", "metric"), ("per_layer", "metric")):
        seen = set()
        for entry in manifest.get(key, ()):
            name = check_name(kind, entry.get("name"))
            if name in seen:
                raise ManifestError(f"two {kind}s named {name!r}")
            seen.add(name)
    for w in manifest.get("workloads", ()):
        check_name("configuration", w.get("config"))
        check_name("traffic", w.get("traffic"))
    return manifest


def cell(name: str, root: Path = ROOT) -> Cell:
    """Cell ``name`` with its configuration, traffic, builder and metrics."""
    check_name("cell", name)
    manifest = load(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise ManifestError(f"no cell {name!r} in {root / 'BENCHMARK.json'}")
    conf = next((c for c in manifest["configs"]
                 if c["name"] == entry["config"]), None)
    if conf is None:
        raise ManifestError(f"cell {name!r}: no configuration "
                            f"{entry['config']!r}")
    here = root / HERE.name
    path = (root / conf["file"]).resolve()
    if here.resolve() not in path.parents:
        raise ManifestError(f"configuration file {conf['file']} lies outside "
                            f"{HERE.name}/")
    config = dict(_read_json(path, f"configuration {conf['name']!r}"),
                  name=conf["name"])
    traffic = dict(_read_json(here / "traffic" / f"{entry['traffic']}.json",
                              f"traffic {entry['traffic']!r}"),
                   name=entry["traffic"])
    builder = check_name("builder", config.get("builder"))
    module = load_module(here / "builders" / f"{builder}.py",
                         f"benchmark_builder_{builder}")
    per_layer = tuple((m["name"], m["unit"], _reader(here, m["name"]))
                      for m in manifest["per_layer"] if _applies(m, name))
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, builder=module,
                end_to_end=tuple((m["name"], m["unit"])
                                 for m in manifest["end_to_end"]
                                 if _applies(m, name)),
                per_layer=per_layer)
