"""A new configuration from new files and new entries only: in a copy of
the benchmark, a configuration with its own file (``tiny``,
``reference``), builder, traffic, limits, plain reference (a copy of
``wpmc_plain`` under another name), a metric that reads a program counter
(``COUNTERS``) and one that reads a program span (``run.sections``).  No
file the benchmark had changes; the tiny cell is correct and its metrics
read; a fault planted in the new reference alone turns it not correct,
so that reference, and not ``wpmc_plain``, judged it."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import spec

ROOT = spec.ROOT
NEW = "em_twin"
CELL = f"{NEW}.p6"
RUN = """
import json, sys, time
import benchmark
from benchmark import cell as C
from benchmark.tests.tiny import tiny_cell
out = {"benchmark": benchmark.__file__}
for name, traced in json.loads(sys.argv[1]):
    c = tiny_cell(name)
    obj, _ = C.result(C.run_cell(c, 2**31 + 77, 0.0, traced, "cpu", time.time()), c)
    out[name] = obj
print(json.dumps(out))
"""
COUNTER_METRIC = '''"""twin_dycore_calls: the dycore's calls a step of the window."""

COUNTERS = ("wrf_partmc_tpu_torch.models.dycore.solve:GRAPH_COUNTS",)


def read(run):
    counts = run.counters.get(COUNTERS[0])
    return sum(counts.values()) / run.steps if counts and run.steps else None
'''
SPAN_METRIC = '''"""twin_transport_host_ms: the host's time in ``wpmc.transport`` a step."""


def read(run):
    return run.sections.get("wpmc.transport", {}).get("host_ms")
'''
FAULT = '''

_plain_step = coupled_step


def coupled_step(cs, *args, **kwargs):
    out, diag = _plain_step(cs, *args, **kwargs)
    return dataclasses.replace(out, dyn=dataclasses.replace(out.dyn, u=out.dyn.u + 0.5)), diag
'''


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _run(tmp, runs):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RUN, json.dumps(runs)], cwd=tmp,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got.pop("benchmark") == str(tmp / "benchmark" / "__init__.py")
    return got


def _add_configuration(tmp, bench):
    b = tmp / "benchmark"
    conf = json.loads((ROOT / "benchmark/configs/em_uniform.json").read_text())
    (b / f"configs/{NEW}.json").write_text(json.dumps(dict(conf, name=NEW,
                                                           reference="twin_plain")))
    (b / f"builders/{NEW}.py").write_text(
        '"""em_uniform\'s assembly, judged by its own reference."""\n\n'
        "from benchmark.builders.em_uniform import build  # noqa: F401\n")
    shutil.copy(b / "workloads/em_uniform.p1000.json", b / f"workloads/{CELL}.json")
    shutil.copy(b / "limits/em_uniform.p1000.json", b / f"limits/{CELL}.json")
    (b / "metrics/twin_dycore_calls.py").write_text(COUNTER_METRIC)
    (b / "metrics/twin_transport_host_ms.py").write_text(SPAN_METRIC)
    shutil.copytree(b / "reference/wpmc_plain", b / "reference/twin_plain",
                    ignore=shutil.ignore_patterns("__pycache__"))
    first = bench["configs"][0]
    metric = {"unit": "ms/step", "better": "lower", "layer": "test", "moves": "step_ms",
              "workloads": [CELL]}
    return dict(
        bench,
        configs=bench["configs"] + [dict(first, name=NEW, file=f"benchmark/configs/{NEW}.json")],
        workloads=bench["workloads"] + [
            {"name": CELL, "config": NEW, "traffic": "p6", "chips": 1, "why": "a test's"}],
        per_layer=bench["per_layer"] + [
            dict(metric, name="twin_dycore_calls", unit="calls/step", source="program_counter"),
            dict(metric, name="twin_transport_host_ms", source="program_span")])


def test_new_configuration_from_new_files_only(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "wrf_partmc_tpu_torch", tmp_path / "wrf_partmc_tpu_torch")
    bench = spec.load_benchmark()
    before = _digests(tmp_path / "benchmark")
    extra = _add_configuration(tmp_path, bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(extra))
    for key, entries in bench.items():           # every entry kept, new ones after
        assert extra[key] == entries or extra[key][:len(entries)] == entries
    after = _digests(tmp_path / "benchmark")
    assert {p: d for p, d in after.items() if p in before} == before
    cell = spec.find_cell(CELL, extra, root=tmp_path)
    assert cell.reference == "benchmark.reference.twin_plain"
    assert cell.config["tiny"] == {"nx": 6, "ny": 6, "nz": 4}

    got = _run(tmp_path, [[CELL, True]])[CELL]
    assert got["correct"] and got["failed"] == 0, got["compared"]
    assert got["metrics"]["twin_dycore_calls"]["value"] == 1.0
    assert got["metrics"]["twin_transport_host_ms"]["value"] > 0.0
    assert "dycore_busy_ms" not in got["metrics"]        # listed for em_uniform.p1000 alone

    with open(tmp_path / "benchmark/reference/twin_plain/models/coupled/driver.py", "a") as f:
        f.write(FAULT)
    got = _run(tmp_path, [[CELL, False], ["em_uniform.p1000", False]])
    assert not got[CELL]["correct"] and got[CELL]["failed"] >= 1, got[CELL]["compared"]
    assert got["em_uniform.p1000"]["correct"], got["em_uniform.p1000"]["compared"]
