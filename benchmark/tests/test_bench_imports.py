"""Nothing the benchmark runs loads JAX or the JAX package, and no plain
reference loads anything of the program: every reference package is
imported and each configuration is built and stepped by its own
(top-level module names compared whole: the port's name begins with the
JAX package's)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "wrf_partmc_tpu"}
PROBE = """
import json, sys, time
from benchmark import spec
t0 = time.time()
{setup}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
RUN_TINY = """
from benchmark import cell as C
from benchmark.tests.tiny import tiny_cell
for w in spec.load_benchmark()["workloads"]:
    c = tiny_cell(w["name"])
    C.result(C.run_cell(c, 7, 0.0, True, "cpu", t0), c)
for m in spec.load_benchmark()["per_layer"] + spec.load_benchmark()["end_to_end"]:
    spec.reader(m["name"])
import benchmark.run, benchmark.control
"""
REFERENCE = """
import importlib, pkgutil
import benchmark.reference as R
from benchmark.tests.tiny import tiny_cell
for m in pkgutil.walk_packages(R.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
for w in spec.load_benchmark()["workloads"]:
    c = tiny_cell(w["name"])
    model, s = spec.builder(c.config["name"]).build(c.config, c.traffic, 7, "cpu",
                                                    root=c.reference)
    model(s)
"""


def _modules(setup: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(setup=setup)], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules(RUN_TINY)
    assert "wrf_partmc_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE)
    assert not mods & (FORBIDDEN | {"wrf_partmc_tpu_torch"})


def test_reference_sources_import_nothing_of_the_program():
    for path in Path(spec.ROOT / "benchmark" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"wrf_partmc_tpu_torch"}, (path, n)
