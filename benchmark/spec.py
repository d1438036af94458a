"""Find a cell and everything it names, by name, from files of their own.

``BENCHMARK.json`` (the repository's root) lists the configurations, the
cells and the metrics.  A cell ``<config>.<traffic>`` then takes

- ``configs/<config>.json``: the configuration's sizes, its source, what
  was reduced and what assumed (the file ``BENCHMARK.json`` names), its
  ``"tiny"`` sizes (what a CPU test run holds) and its ``"reference"``:
  the package under ``reference/`` that judges its output;
- ``builders/<config>.py``: how it is built from a seed, by the program
  and, on the same assembly, by the plain reference;
- ``workloads/<config>.<traffic>.json``: the cell's traffic (particles a
  cell, slots a cell);
- ``limits/<config>.<traffic>.json``: the limit of each number the output
  comparison reads;
- ``metrics/<metric>.py``: one reader for each metric the cell reports,
  with the program's sections it times (``SITES``) and the program's
  counters it reads (``COUNTERS``).

Adding a cell, a configuration or a metric adds files and entries; no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from .builders import REFERENCES

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class SpecError(ValueError):
    """A cell, configuration or metric that the files do not describe
    consistently: the run refuses it."""


@dataclass(frozen=True)
class Cell:
    name: str
    entry: dict            # the cell's entry of BENCHMARK.json
    config: dict           # configs/<config>.json
    traffic: dict          # workloads/<cell>.json
    limits: dict           # limits/<cell>.json: number -> limit
    end_to_end: tuple      # the end-to-end metric entries the cell reports
    per_layer: tuple       # the per-layer metric entries the cell reports

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def reference(self) -> str:
        """The root of the configuration's plain reference."""
        return f"{REFERENCES}.{self.config['reference']}"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


def _load_config(path: Path, name: str, root: Path) -> dict:
    """A configuration's file, refused by its path unless it states its
    ``"tiny"`` sizes and a ``"reference"`` package that exists."""
    config = _load_json(path, f"configuration {name!r}")
    tiny = config.get("tiny")
    if not isinstance(tiny, dict) or not tiny:
        raise SpecError(f"{path}: no \"tiny\" object (the sizes a CPU test run holds)")
    ref = config.get("reference")
    if not isinstance(ref, str) or not ref.isidentifier():
        raise SpecError(f"{path}: no \"reference\" naming a package under benchmark/reference/")
    if not (root / "benchmark" / "reference" / ref / "__init__.py").is_file():
        raise SpecError(f"{path}: \"reference\" {ref!r} is no package under "
                        "benchmark/reference/")
    return config


def reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``,
    or, without that key, every cell (a per-layer metric: every cell that
    reports its ``moves``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def find_cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics.  Raises :class:`SpecError` when a file is missing or a
    per-layer metric of the cell moves an end-to-end metric the cell does
    not report."""
    root = Path(root)
    bench = load_benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"no cell {name!r} in BENCHMARK.json: "
                        f"{[w['name'] for w in bench['workloads']]}")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise SpecError(f"cell {name!r}: no configuration {entry['config']!r}")
    if name != f"{entry['config']}.{entry['traffic']}":
        raise SpecError(f"cell {name!r} is not named <config>.<traffic>")
    here = root / "benchmark"
    e2e = tuple(m for m in bench["end_to_end"] if reports(m, name))
    e2e_names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"] if reports(m, name, e2e_names))
    for m in per_layer:
        if m["moves"] not in e2e_names:
            raise SpecError(f"cell {name!r}: per-layer metric {m['name']!r} moves "
                            f"{m['moves']!r}, which the cell does not report")
    return Cell(name=name, entry=entry,
                config=_load_config(root / conf["file"], conf["name"], root),
                traffic=_load_json(here / "workloads" / f"{name}.json", f"traffic of {name!r}"),
                limits=_load_json(here / "limits" / f"{name}.json", f"limits of {name!r}"),
                end_to_end=e2e, per_layer=per_layer)


def _load_module(path: Path, qualname: str):
    if not path.is_file():
        raise SpecError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(qualname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The reader of ``metric``: ``metrics/<metric>.py``."""
    return _load_module(Path(root) / "benchmark" / "metrics" / f"{metric}.py",
                        f"benchmark.metrics.{metric}")


def builder(config: str, root: Path = ROOT):
    """How ``config`` is built: ``builders/<config>.py``."""
    return _load_module(Path(root) / "benchmark" / "builders" / f"{config}.py",
                        f"benchmark.builders.{config}")
