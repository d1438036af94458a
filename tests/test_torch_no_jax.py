"""The port never imports jax: every module of ``wrf_partmc_tpu_torch`` is
imported in a fresh interpreter, which must end with no jax module loaded
and no module of the JAX package: the port keeps its own ``config`` and
``constants``."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, json, pkgutil, sys
import wrf_partmc_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names,
                  "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))),
                  "reference": sorted(m for m in sys.modules if m.startswith("wrf_partmc_tpu.") or m == "wrf_partmc_tpu")}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "wrf_partmc_tpu_torch.entry" in out["modules"]
    assert "wrf_partmc_tpu_torch.models.coupled.driver" in out["modules"]
    for m in ("models.partmc.seasalt", "models.physics.surface",
              "models.physics.cumulus", "models.physics.sfs_nba",
              "models.physics.scm_forcing", "models.dycore.real", "models.partmc.box",
              "models.partmc.box_model", "utils.llxy", "utils.spec_file", "tools.make_inputs",
              "tools.mozbc", "tools.make_emissions", "tools.urban_plume",
              "parallel.mesh", "parallel.halo", "parallel.distributed", "parallel.launch"):
        assert "wrf_partmc_tpu_torch." + m in out["modules"], m
    assert out["jax"] == []
    assert out["reference"] == []
