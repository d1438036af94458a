"""BENCHMARK.json and the files it names: the contract's shapes, and a
cell, configuration or metric found by name from files of its own."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert all(LINE.match(w) for w in bench["command"]) and len(bench["command"]) <= 32
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and LINE.match(c["source"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_cell_found_by_name(bench):
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert callable(spec.builder(w["config"]).build)
        for m in (*cell.end_to_end, *cell.per_layer):
            assert callable(spec.reader(m["name"]).read)
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def _digests(folder: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files_only(tmp_path, bench):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark")
    first = bench["workloads"][0]
    new = "em_uniform.p500"
    extra = dict(bench, workloads=bench["workloads"] + [
        dict(first, name=new, config="em_uniform", traffic="p500")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(extra))
    traffic = json.loads((tmp_path / "benchmark/workloads/em_uniform.p1000.json").read_text())
    (tmp_path / f"benchmark/workloads/{new}.json").write_text(
        json.dumps(dict(traffic, particles_per_cell=500, slots_per_cell=640)))
    (tmp_path / f"benchmark/limits/{new}.json").write_text(
        (tmp_path / "benchmark/limits/em_uniform.p1000.json").read_text())
    cell = spec.find_cell(new, root=tmp_path)
    assert cell.traffic["particles_per_cell"] == 500 and cell.config["name"] == "em_uniform"
    after = _digests(tmp_path / "benchmark")
    assert {p: d for p, d in after.items() if p in before} == before
    assert len(after) == len(before) + 2


def test_refuses_a_metric_moving_what_the_cell_does_not_report(bench):
    cell = bench["workloads"][0]["name"]
    bad = dict(bench, per_layer=bench["per_layer"] + [
        {"name": "x_ms", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "dycore", "moves": "tokens_per_s", "workloads": [cell]}])
    with pytest.raises(spec.SpecError, match="does not report"):
        spec.find_cell(cell, bad)


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the run exits non-zero and prints no result."""
    import subprocess
    import sys

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "em_uniform.p1000", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("key,value", [("tiny", None), ("reference", None),
                                       ("reference", "no_such_reference")])
def test_a_configuration_without_tiny_or_reference_is_refused_by_name(tmp_path, bench, key,
                                                                      value):
    """A configuration file without its CPU test sizes or its plain
    reference is refused, naming the file, before any test runs it."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf = bench["configs"][0]
    path = tmp_path / conf["file"]
    data = json.loads(path.read_text())
    data.pop(key) if value is None else data.update({key: value})
    path.write_text(json.dumps(data))
    cell = next(w["name"] for w in bench["workloads"] if w["config"] == conf["name"])
    with pytest.raises(spec.SpecError, match=re.escape(str(path)) + f'.*"{key}"'):
        spec.find_cell(cell, bench, root=tmp_path)


@pytest.mark.parametrize("root", ["wrf_partmc_tpu", "benchmark", "benchmark.builders",
                                  "benchmark.reference", "benchmark.reference.wpmc_plain.ops",
                                  "benchmark.reference.no-such"])
def test_builders_take_the_program_or_a_reference_package_alone(root):
    from benchmark import builders

    with pytest.raises(ValueError, match="neither"):
        builders.module(root, "grid")
    assert builders.module(builders.PROGRAM, "grid").__name__ == "wrf_partmc_tpu_torch.grid"
    assert builders.module("benchmark.reference.wpmc_plain", "grid").__file__.endswith(
        "benchmark/reference/wpmc_plain/grid.py")
