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
* The block dycore step (``solve_step`` on each rank's block of the state
  and its block grid, every horizontal access a block stencil with halo
  exchanges) at (2, 2) against the port's whole-domain ``solve_step``,
  sliced to the block: the ARW core periodic (em_uniform), periodic with
  WENO5/3, the prognostic TKE and the NBA stresses (the LES options), and
  open with the CARES physics (Morrison, Smagorinsky, damping); the linear
  core periodic and open.  Every dycore field and the step diagnostics
  (the outflow probabilities, xkhh and the mass fluxes) bit-equal, except
  on the CARES shape (8 levels, 6x5 blocks of 12x10): there the ARW
  core's column sums over the levels (``torch.sum(..., dim=0)`` of the
  mass divergence in ``_omega_from_fluxes`` and the acoustic substeps'
  ``mu_t``) round differently, because ATen picks its reduction order by
  the tensor's size, so the fields agree within 1e-4 of each field's
  scale (the largest deviation, p_p's 2.4e-5, is the pressure's
  cancellation; the same sums over the levels in sequence give bit-equal
  blocks).

The decomposed coupled step is in tests/test_torch_sharded_step.py, which
uses this file's rank runner.
"""

import concurrent.futures
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
from wrf_partmc_tpu_torch.parallel import distributed as pdist
from wrf_partmc_tpu_torch.parallel.mesh import shard_field
from wrf_partmc_tpu_torch.utils.tree import tree_map
assert pdist.init_from_env("cpu", timeout_s={timeout})
mesh = pdist.global_mesh()
task = torch.load({path!r}, weights_only=False)
torch.set_flush_denormal(task.get("flush_denormal", False))
from wrf_partmc_tpu_torch.grid import block_grid
from wrf_partmc_tpu_torch.parallel.mesh import block_of
if task["kind"] == "transport":
    from wrf_partmc_tpu_torch.models.coupled.transport import transport_step
    grid = block_grid(task["grid"], mesh)
    cut = lambda t: block_of(t, mesh, *grid.global_shape)
    aero = tree_map(lambda t: shard_field(t, mesh), task["aero"])
    out = transport_step(aero, tree_map(cut, task["probs"]), cut(task["xkhh"]),
                         cut(task["exch"]), grid, task["cfg"], task["dt"], task["key"],
                         cut(task["rho3"]), cut(task["dz3"]), mesh=mesh)
elif task["kind"] == "dycore":
    from wrf_partmc_tpu_torch.models.dycore.solve import solve_step
    out = {{}}
    for name, (dyn, grid, cfg) in task["cases"].items():
        cut = lambda t: block_of(t, mesh, grid.ny, grid.nx)
        out[name] = solve_step(tree_map(cut, dyn), block_grid(grid, mesh), cfg)
elif task["kind"] == "options":
    from wrf_partmc_tpu_torch.models.coupled import transport
    from wrf_partmc_tpu_torch.models.coupled.driver import decompose
    from wrf_partmc_tpu_torch.option_sets import build_option_set
    from wrf_partmc_tpu_torch.parallel import halo
    cap = {{}}
    nfp, vop = transport.normalized_face_probs, transport.vertical_operator
    transport.normalized_face_probs = lambda *a: cap.setdefault("ph", nfp(*a))
    transport.vertical_operator = lambda *a, **k: cap.setdefault("R", vop(*a, **k))
    out = {{}}
    for name, (args, state) in task["sets"].items():
        model, _ = build_option_set(name, *args, device="cpu")
        model, state = decompose(model, state, mesh)
        halo.reset_counts()
        step = model(state)
        out[name] = (step, halo.read_counts(), model.last_diag, dict(cap))
        cap.clear()
else:
    if task["kind"] == "cares":
        from wrf_partmc_tpu_torch.cares import build_cares_shape as build
    else:
        from wrf_partmc_tpu_torch.entry import build
    from wrf_partmc_tpu_torch.parallel import halo
    model, state = build(*task["args"], **task.get("kw", {{}}), device="cpu", mesh=mesh)
    halo.reset_counts()
    out = (model(state), halo.read_counts())
torch.save(out, {path!r} + f".{{mesh.rank}}")
pdist.shutdown()
"""


def run_ranks(tmp_path, name: str, task: dict, n: int = 4):
    """Run ``task`` on ``n`` gloo ranks; returns each rank's result."""
    path = str(tmp_path / f"{name}.pt")
    torch.save(task, path)
    code = _RANK.format(repo=REPO, timeout=RANK_TIMEOUT_S, path=path)
    results = spawn(n, [sys.executable, "-c", code], RANK_TIMEOUT_S, cwd=REPO)
    for r, (code_r, out) in enumerate(results):
        assert code_r == 0, f"rank {r} exited {code_r}:\n{out[-3000:]}"
    return [torch.load(f"{path}.{r}", weights_only=False) for r in range(n)]


def ranks_in_background(tmp_path, name: str, task: dict, n: int = 4):
    """Start ``run_ranks`` in a thread and return its future: the test
    process computes its references while the ranks step."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(run_ranks, tmp_path, name, task, n)
    finally:
        pool.shutdown(wait=False)


def block(a, iy, ix, py, px, axes=(1, 2)):
    """Block (iy, ix) of a (py, px) split of numpy ``a`` on ``axes``."""
    ny, nx = a.shape[axes[0]] // py, a.shape[axes[1]] // px
    axes = tuple(ax % a.ndim for ax in axes)
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
    np_ = lambda x: jax.tree.map(np.asarray, x)
    task = dict(kind="transport", aero=from_numpy(np_(cs.aero)),
                probs=from_numpy(np_(diag)).probs,
                xkhh=torch.tensor(np.asarray(diag.xkhh)), exch=torch.tensor(np.asarray(exch)),
                grid=from_numpy(np_(grid)), cfg=cfg, dt=cfg.dynamics.dt, key=rng.Key(kd(key)),
                rho3=torch.tensor(np.asarray(rho3)), dz3=torch.tensor(np.asarray(dz3)))
    outs = ranks_in_background(tmp_path_factory.mktemp(request.param), "transport", task)
    mesh = jax_make_mesh(jax.devices()[:4], shape=(2, 2))
    ref, rdiag = jax.jit(lambda a, k: jtransport.transport_step(
        a, diag.probs, diag.xkhh, exch, grid, cfg, cfg.dynamics.dt, k, mesh=mesh,
        return_diag=True, rho3=rho3, dz3=dz3))(cs.aero, key)
    return np_(ref), {k: float(v) for k, v in np_(rdiag).items()}, outs.result()


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


def _perturbed_dyn(cfg, grid, seed: int):
    """The uniform initial state with seeded random winds, theta', moisture
    and tracers, so every stencil reads a field that varies across the rank
    edges."""
    from wrf_partmc_tpu_torch.models.dycore.ideal import init_uniform

    r = np.random.default_rng(seed)
    dyn = init_uniform(cfg, grid, 5.0, 2.0)
    f = lambda a, scale, base=0.0: torch.tensor(
        (base + scale * r.random(tuple(a.shape))).astype(np.float32))
    rep = dict(u=f(dyn.u, 8.0, -4.0), v=f(dyn.v, 8.0, -4.0), w=f(dyn.w, 0.2, -0.1),
               theta_p=f(dyn.theta_p, 2.0, -1.0), moist=f(dyn.moist, 1e-3),
               chem=f(dyn.chem, 1e-2), num_conc=f(dyn.num_conc, 1e6),
               tke=f(dyn.tke, 0.5, 0.01))
    if dyn.mu is not None:
        rep["mu"] = f(dyn.mu, 20.0, -10.0)
    return dataclasses.replace(dyn, **rep)


def _dycore_cases():
    """name -> (whole-domain dycore state, grid, config) of the block
    dycore test."""
    from wrf_partmc_tpu_torch.cares import cares_config
    from wrf_partmc_tpu_torch.grid import make_grid

    em = make_config(8, 8, 4, 16, 48)
    les = em.replace(dynamics=dataclasses.replace(
        em.dynamics, diff_opt=2, km_opt=2, sfs_opt=1, h_adv_order="weno5",
        v_adv_order="weno3"))
    cares = cares_config(12, 10, 8, n_part=16, cap=32).replace(n_class=8)
    lin = make_config(8, 8, 4, 16, 48, dyn_opt="linear")
    cfgs = dict(arw_periodic=em, arw_les=les, arw_open_cares=cares,
                linear_periodic=lin, linear_open=lin.replace(boundary=OPEN))
    out = {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        grid = make_grid(cfg)
        out[name] = (_perturbed_dyn(cfg, grid, i), grid, cfg)
    return out


@pytest.fixture(scope="module")
def dycore_blocks(tmp_path_factory):
    from wrf_partmc_tpu_torch.models.dycore.solve import solve_step

    cases = _dycore_cases()
    outs = ranks_in_background(tmp_path_factory.mktemp("dycore"), "dycore",
                               dict(kind="dycore", cases=cases))
    whole = {name: solve_step(dyn, grid, cfg) for name, (dyn, grid, cfg) in cases.items()}
    return whole, outs.result()


# cases whose blocks agree within this share of each field's scale instead
# of bit for bit (the module docstring: the ARW column sums at 8 levels)
SCALE_TOL = {"arw_open_cares": 1e-4}


@pytest.mark.parametrize("case", ["arw_periodic", "arw_les", "arw_open_cares",
                                  "linear_periodic", "linear_open"])
def test_block_dycore_step(dycore_blocks, case):
    """Each rank's block step equals the whole-domain step's block: the
    halo exchanges move data only, and every other operation of the step
    is elementwise or column-local."""
    whole, outs = dycore_blocks
    ref_dyn, ref_diag = to_numpy(whole[case])
    tol = SCALE_TOL.get(case)

    def check(out, ref, what):
        if tol is None:
            np.testing.assert_array_equal(out, ref, err_msg=what)
        else:
            np.testing.assert_allclose(out, ref, rtol=0,
                                       atol=tol * float(np.abs(ref).max()), err_msg=what)

    n_checked = 0
    for rank, out in enumerate(outs):
        iy, ix = divmod(rank, 2)
        dyn, diag = to_numpy(out[case])
        cut = lambda a: block(a, iy, ix, 2, 2, axes=(-2, -1))
        for f in dataclasses.fields(ref_dyn):
            r = getattr(ref_dyn, f.name)
            if r is None:
                assert getattr(dyn, f.name) is None, f.name
                continue
            check(getattr(dyn, f.name), cut(r), f"{case} rank {rank} {f.name}")
            n_checked += 1
        for f in dataclasses.fields(ref_diag.probs):
            check(getattr(diag.probs, f.name), cut(getattr(ref_diag.probs, f.name)),
                  f"{case} rank {rank} probs.{f.name}")
        for name in ("xkhh", "rho_u", "rho_v", "rho_w"):
            check(getattr(diag, name), cut(getattr(ref_diag, name)), f"{case} rank {rank} {name}")
    assert n_checked >= 4 * 9


def test_dryrun_multichip_gloo():
    out = dryrun_multichip(4, device="cpu", timeout_s=RANK_TIMEOUT_S)["output"]
    assert "dryrun_multichip OK: mesh 2x2" in out
