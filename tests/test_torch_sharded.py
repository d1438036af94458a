"""The decomposed transport of the port against the JAX package's mesh
path, block by block, on the CPU, and the decomposed dry run.

The port runs its ranks as gloo processes (``parallel.launch.spawn``, each
with a time limit that kills every rank), the JAX package its
``shard_map`` path on the conftest's virtual CPU devices at the same mesh
shape; a rank at (iy, ix) is held against the same block of the JAX
result.

* ``transport_step_sharded`` at (2, 2), periodic and open, on the
  em_uniform state of ``__graft_entry__._build`` at 12x12x4 (16 particles
  per cell, capacity 48) with numpy winds: each rank draws with its key
  folded by (iy, ix), and the movers of its edge columns reach the
  neighbouring rank.  Particles slot for slot (alive masks and integer
  fields exact, floats rtol 1e-5, as tests/test_torch_open_bc.py), the
  counters summed over the ranks exactly.
* ``entry.dryrun_multichip(4)`` on 4 gloo ranks.

The decomposed coupled step is in tests/test_torch_sharded_step.py, which
uses this file's rank runner.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.coupled import driver as jdriver
from wrf_partmc_tpu.models.coupled import transport as jtransport
from wrf_partmc_tpu.models.dycore.solve import solve_step as jax_solve_step
from wrf_partmc_tpu.models.physics.pbl import k_profile_exch_h as jax_exch
from wrf_partmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wrf_partmc_tpu_torch.config import BoundaryConfig
from wrf_partmc_tpu_torch.convert import from_numpy, to_numpy
from wrf_partmc_tpu_torch.entry import dryrun_multichip, make_config
from wrf_partmc_tpu_torch.parallel.launch import spawn
from wrf_partmc_tpu_torch.utils import rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 180.0
OPEN = BoundaryConfig(periodic_x=False, periodic_y=False, open_xs=True, open_xe=True,
                      open_ys=True, open_ye=True, spec_zone=1, relax_zone=3)
INT_FIELDS = ("pid", "source", "w_class", "hyst_leg")

# one rank of a gloo world: loads the task's inputs, runs it on its block
# and saves what it gives
_RANK = """
import sys
import torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from wrf_partmc_tpu_torch.parallel import distributed as pdist
from wrf_partmc_tpu_torch.parallel.mesh import shard_field
from wrf_partmc_tpu_torch.utils.tree import tree_map
assert pdist.init_from_env("cpu", timeout_s={timeout})
mesh = pdist.global_mesh()
task = torch.load({path!r}, weights_only=False)
torch.set_flush_denormal(task.get("flush_denormal", False))
if task["kind"] == "transport":
    from wrf_partmc_tpu_torch.models.coupled.transport import transport_step
    aero = tree_map(lambda t: shard_field(t, mesh), task["aero"])
    out = transport_step(aero, task["probs"], task["xkhh"], task["exch"], task["grid"],
                         task["cfg"], task["dt"], task["key"], task["rho3"], task["dz3"],
                         mesh=mesh)
else:
    if task["kind"] == "cares":
        from wrf_partmc_tpu_torch.cares import build_cares_shape as build
    else:
        from wrf_partmc_tpu_torch.entry import build
    model, state = build(*task["args"], **task.get("kw", {{}}), device="cpu", mesh=mesh)
    out = model(state)
torch.save(out, {path!r} + f".{{mesh.rank}}")
pdist.shutdown()
"""


def run_ranks(tmp_path, name: str, task: dict, n: int = 4):
    """Run ``task`` on ``n`` gloo ranks; returns each rank's result."""
    path = str(tmp_path / f"{name}.pt")
    torch.save(task, path)
    code = _RANK.format(repo=REPO, timeout=RANK_TIMEOUT_S, path=path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    results = spawn(n, [sys.executable, "-c", code], RANK_TIMEOUT_S, env=env, cwd=REPO)
    for r, (code_r, out) in enumerate(results):
        assert code_r == 0, f"rank {r} exited {code_r}:\n{out[-3000:]}"
    return [torch.load(f"{path}.{r}", weights_only=False) for r in range(n)]


def block(a, iy, ix, py, px, axes=(1, 2)):
    """Block (iy, ix) of a (py, px) split of numpy ``a`` on ``axes``."""
    ny, nx = a.shape[axes[0]] // py, a.shape[axes[1]] // px
    idx = [slice(None)] * a.ndim
    idx[axes[0]] = slice(iy * ny, (iy + 1) * ny)
    idx[axes[1]] = slice(ix * nx, (ix + 1) * nx)
    return a[tuple(idx)]


def aero_block(a, iy, ix, py, px):
    return dataclasses.replace(a, **{f.name: block(getattr(a, f.name), iy, ix, py, px)
                                     for f in dataclasses.fields(a)})


def assert_aero_equal(ref, out, rtol=1e-5):
    """Alive masks and integer fields exact, floats to rtol."""
    alive = ref.num > 0
    np.testing.assert_array_equal(out.num > 0, alive)
    np.testing.assert_allclose(out.num, ref.num, rtol=rtol, atol=0)
    np.testing.assert_array_equal(out.next_id, ref.next_id)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(np.where(alive, getattr(out, name), 0),
                                      np.where(alive, getattr(ref, name), 0), err_msg=name)
    for name in ("vol", "src_vol"):
        a, b = getattr(out, name), getattr(ref, name)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6 * np.abs(b).max(), err_msg=name)


def kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.fixture(scope="module", params=["periodic", "open"])
def transport_case(request, tmp_path_factory):
    cfg = make_config(12, 12, 4, 16, 48).replace(n_class=8)
    if request.param == "open":
        cfg = cfg.replace(boundary=OPEN)
    _, cs = ge._build(nx=12, ny=12, nz=4, n_part=16, cap=48, chem_on=False)
    grid = jax_make_grid(cfg)
    r = np.random.default_rng(1)
    dyn = jdriver.partmc_to_wrf(cs, grid, cfg)
    dyn = dataclasses.replace(       # winds of both signs, across every edge
        dyn, u=jnp.asarray(r.normal(0.0, 8.0, dyn.u.shape), jnp.float32),
        v=jnp.asarray(r.normal(0.0, 8.0, dyn.v.shape), jnp.float32))
    dyn2, diag = jax.jit(lambda d: jax_solve_step(d, grid, cfg))(dyn)
    vol3 = jdriver.cell_volume_3d(dyn2, grid)
    rho3 = jdriver.cell_air_mass(dyn2, grid) / vol3
    dz3 = vol3 / (grid.dx * grid.dy)
    exch = jax_exch(grid, 0.4, 800.0)
    key = jax.random.fold_in(jax.random.key(3), 7)
    mesh = jax_make_mesh(jax.devices()[:4], shape=(2, 2))
    ref, rdiag = jax.jit(lambda a, k: jtransport.transport_step(
        a, diag.probs, diag.xkhh, exch, grid, cfg, cfg.dynamics.dt, k, mesh=mesh,
        return_diag=True, rho3=rho3, dz3=dz3))(cs.aero, key)
    np_ = lambda x: jax.tree.map(np.asarray, x)
    task = dict(kind="transport", aero=from_numpy(np_(cs.aero)),
                probs=from_numpy(np_(diag)).probs,
                xkhh=torch.tensor(np.asarray(diag.xkhh)), exch=torch.tensor(np.asarray(exch)),
                grid=from_numpy(np_(grid)), cfg=cfg, dt=cfg.dynamics.dt, key=rng.Key(kd(key)),
                rho3=torch.tensor(np.asarray(rho3)), dz3=torch.tensor(np.asarray(dz3)))
    outs = run_ranks(tmp_path_factory.mktemp(request.param), "transport", task)
    return np_(ref), {k: float(v) for k, v in np_(rdiag).items()}, outs


def test_transport_step_sharded_blocks(transport_case):
    ref, _, outs = transport_case
    for rank, (aero, _) in enumerate(outs):
        iy, ix = divmod(rank, 2)
        assert_aero_equal(aero_block(ref, iy, ix, 2, 2), to_numpy(aero))


def test_transport_step_sharded_counters(transport_case):
    ref, rdiag, outs = transport_case
    assert rdiag["movers"] > 0
    for _, diag in outs:
        assert {k: float(v) for k, v in diag.items()} == rdiag


def test_dryrun_multichip_gloo():
    out = dryrun_multichip(4, device="cpu", timeout_s=RANK_TIMEOUT_S)["output"]
    assert "dryrun_multichip OK: mesh 2x2" in out
