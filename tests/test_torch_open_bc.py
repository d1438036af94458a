"""Open lateral boundaries of the port against the JAX package: the wrfbdy
specified + relaxation zones (``bdy``), the inflow gas BC and particle
resampling (``boundary``), the open-boundary transport particle for
particle, and one ARW dycore step with ``periodic_x/y=False``.

The transport and dycore inputs are the em_uniform state of
``__graft_entry__._build`` at 12x12x4 (16 particles per cell, capacity 48)
with the boundaries opened.  Random fields and winds are made from a seed
with numpy.  The boundary blends are the same float32 arithmetic in both
packages and are held to rtol 1e-6; the particle steps draw the same
threefry bits, so alive masks, slots and integer fields agree exactly and
floats to rtol 1e-5 (the resampled diameters pass through erfinv, whose last
ulps differ between the frameworks).  The dycore is held as in
``tests/test_torch_dycore.py`` (rtol 1e-4, floor 1e-4 of each field's
scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.coupled import bdy as jbdy
from wrf_partmc_tpu.models.coupled import boundary as jboundary
from wrf_partmc_tpu.models.coupled import driver as jdriver
from wrf_partmc_tpu.models.coupled import transport as jtransport
from wrf_partmc_tpu.models.dycore.solve import solve_step as jax_solve_step
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.dist import concat_dists as jax_concat_dists
from wrf_partmc_tpu.models.partmc.dist import make_mode as jax_make_mode
from wrf_partmc_tpu.models.partmc.scenario import constant_scenario as jax_constant_scenario
from wrf_partmc_tpu.models.physics.pbl import k_profile_exch_h as jax_exch

from wrf_partmc_tpu_torch.config import BoundaryConfig
from wrf_partmc_tpu_torch.convert import from_numpy, to_numpy
from wrf_partmc_tpu_torch.entry import make_config
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.coupled import bdy, boundary, transport
from wrf_partmc_tpu_torch.models.dycore.solve import solve_step

OPEN = BoundaryConfig(periodic_x=False, periodic_y=False, open_xs=True, open_xe=True,
                      open_ys=True, open_ye=True, spec_zone=1, relax_zone=3)
INT_FIELDS = ("pid", "source", "w_class", "hyst_leg")


def kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def assert_aero_equal(ref, out, rtol=1e-5):
    """Alive masks and integer fields exact, floats to rtol, dead slots by
    num == 0 only."""
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
    np.testing.assert_allclose(np.where(alive, out.t_create, 0),
                               np.where(alive, ref.t_create, 0), rtol=1e-6)


@pytest.fixture(scope="module")
def setup():
    cfg = make_config(12, 12, 4, 16, 48).replace(n_class=8, boundary=OPEN)
    _, cs = ge._build(nx=12, ny=12, nz=4, n_part=16, cap=48, chem_on=False)
    grid = jax_make_grid(cfg)
    r = np.random.default_rng(0)
    dyn = jdriver.partmc_to_wrf(cs, grid, cfg)
    dyn = dataclasses.replace(      # winds of both signs at every edge
        dyn, u=jnp.asarray(r.normal(0.0, 6.0, dyn.u.shape), jnp.float32),
        v=jnp.asarray(r.normal(0.0, 6.0, dyn.v.shape), jnp.float32),
        chem=jnp.asarray(r.uniform(0.0, 0.05, dyn.chem.shape), jnp.float32))
    dyn2, diag = jax.jit(lambda d: jax_solve_step(d, grid, cfg))(dyn)
    vol3 = jdriver.cell_volume_3d(dyn2, grid)
    rho3 = jdriver.cell_air_mass(dyn2, grid) / vol3
    j = dict(grid=grid, aero=cs.aero, dyn=dyn, dyn2=dyn2, diag=diag, rho3=rho3,
             dz3=vol3 / (grid.dx * grid.dy), exch=jax_exch(grid, 0.4, 800.0),
             ad=jax_make_aero_data())
    t = {k: from_numpy(jax.tree.map(np.asarray, v)) for k, v in j.items()}
    return cfg, j, t


# ---- the dycore at open boundaries ----------------------------------------

FIELDS = ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem", "num_conc", "tke"]


@pytest.mark.parametrize("name", FIELDS)
def test_solve_step_open_boundaries(setup, name):
    cfg, j, t = setup
    new, _ = solve_step(t["dyn"], make_grid(cfg), cfg)
    ref, out = np.asarray(getattr(j["dyn2"], name)), to_numpy(getattr(new, name))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * float(np.abs(ref).max()))


def test_solve_step_open_boundary_probs(setup):
    cfg, j, t = setup
    _, diag = solve_step(t["dyn"], make_grid(cfg), cfg)
    for face in ("xm", "xp", "ym", "yp", "zm", "zp"):
        np.testing.assert_allclose(to_numpy(getattr(diag.probs, face)),
                                   np.asarray(getattr(j["diag"].probs, face)),
                                   rtol=1e-4, atol=1e-6, err_msg=face)
    np.testing.assert_allclose(to_numpy(diag.xkhh), np.asarray(j["diag"].xkhh),
                               rtol=1e-4, atol=1e-4 * float(np.abs(j["diag"].xkhh).max()))


# ---- the wrfbdy contract --------------------------------------------------

def _states(j, n=3):
    r = np.random.default_rng(1)
    base = jax.tree.map(np.asarray, j["dyn"])
    return [dataclasses.replace(base, **{
        f: (getattr(base, f) + r.normal(0.0, s, getattr(base, f).shape)).astype(np.float32)
        for f, s in (("u", 2.0), ("v", 2.0), ("theta_p", 1.0), ("mu", 50.0),
                     ("ph", 5.0), ("moist", 1e-4), ("chem", 1e-3))}) for _ in range(n)]


@pytest.mark.parametrize("t_now", [0.0, 1800.0, 5000.0, 9000.0])
def test_specified_relax(setup, t_now):
    cfg, j, _ = setup
    states = _states(j)
    times = [0.0, 3600.0, 7200.0]
    jb = jbdy.make_bdy(jnp.asarray(times), [jax.tree.map(jnp.asarray, s) for s in states],
                       width=4, chem=True)
    tb = bdy.make_bdy(times, [from_numpy(s) for s in states], width=4, chem=True)
    assert set(tb.slabs) == set(jb.slabs) == {"u", "v", "theta_p", "moist", "mu", "ph", "chem"}
    for name in jb.slabs:
        for e in bdy.EDGES:
            np.testing.assert_array_equal(tb.slabs[name][e].numpy(),
                                          np.asarray(jb.slabs[name][e]))
    np.testing.assert_array_equal(to_numpy(bdy.zone_weights(make_grid(cfg), cfg)),
                                  np.asarray(jbdy.zone_weights(j["grid"], cfg, 10.0)))
    field = jax.tree.map(np.asarray, j["dyn2"])
    ref = jax.tree.map(np.asarray, jax.jit(lambda d, b, tt: jbdy.apply_specified_relax(
        d, b, tt, j["grid"], cfg))(field, jb, jnp.float32(t_now)))
    out = to_numpy(bdy.apply_specified_relax(from_numpy(field), tb, t_now,
                                             make_grid(cfg), cfg))
    for name in ("u", "v", "theta_p", "moist", "mu", "ph", "chem", "w", "num_conc"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name), rtol=1e-6,
                                   atol=1e-6 * np.abs(getattr(ref, name)).max(), err_msg=name)
    assert not np.allclose(ref.u[:, 0], field.u[:, 0])          # the edges were forced
    np.testing.assert_array_equal(ref.u[:, 5:-5, 5:-5], field.u[:, 5:-5, 5:-5])


# ---- inflow gas BC and particle resampling ---------------------------------

def _scenario(j):
    """A constant scenario whose background has two aerosol modes and a
    gas background, so the inflow cells have something to take."""
    ad = j["ad"]
    vf = np.zeros(ad.n_spec)
    vf[0], vf[3] = 0.7, 0.3
    back = jax_concat_dists([jax_make_mode(2e9, 8e-8, 1.7, vf, source=0, w_class=0),
                             jax_make_mode(3e8, 3e-7, 1.5, vf, source=0, w_class=0)])
    scn = jax_constant_scenario(ad, 32, back)
    return dataclasses.replace(scn, back_dist=back, back_gas=jnp.asarray(
        np.random.default_rng(2).uniform(0.5, 2.0, 32), jnp.float32))


def test_edge_inflow_and_gas_bc(setup):
    cfg, j, t = setup
    scn = _scenario(j)
    ref_m = np.asarray(jboundary.edge_inflow_masks(j["dyn2"], j["grid"], cfg))
    grid = make_grid(cfg)
    out_m = boundary.edge_inflow_masks(t["dyn2"], grid, cfg).numpy()
    np.testing.assert_array_equal(out_m, ref_m)
    assert 0 < ref_m.sum() < ref_m.size and not ref_m[:, 1:-1, 1:-1].any()
    gas = np.random.default_rng(3).uniform(0.0, 5.0, (4, 12, 12, 32)).astype(np.float32)
    ref = jboundary.apply_gas_open_bc(gas, j["dyn2"], scn, j["grid"], cfg)
    out = boundary.apply_gas_open_bc(torch.tensor(gas), t["dyn2"],
                                     from_numpy(jax.tree.map(np.asarray, scn)), grid, cfg)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_resample_inflow_particles(setup):
    """The STREAM_BC draws through ``dist.sample_particles``: modes (the
    categorical draw), multiplicities, ids and classes bit for bit, volumes
    to the erfinv ulps."""
    cfg, j, t = setup
    scn = _scenario(j)
    key = jax.random.fold_in(jax.random.key(0), 6)
    ref = jax.tree.map(np.asarray, jax.jit(lambda a, d: jboundary.resample_inflow_particles(
        a, d, scn, j["ad"], j["grid"], cfg, key))(j["aero"], j["dyn2"]))
    out = to_numpy(boundary.resample_inflow_particles(
        t["aero"], t["dyn2"], from_numpy(jax.tree.map(np.asarray, scn)), t["ad"],
        make_grid(cfg), cfg, kd(key)))
    np.testing.assert_array_equal(out.num, ref.num)
    for name in ("pid", "source", "w_class", "t_create", "next_id", "hyst_leg", "src_id"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(out.vol, ref.vol, rtol=1e-5, atol=0.0)
    inflow = np.asarray(jboundary.edge_inflow_masks(j["dyn2"], j["grid"], cfg))
    assert (ref.next_id[inflow] == np.asarray(j["aero"].next_id)[inflow] + 16).all()


# ---- open-boundary transport ------------------------------------------------

def test_open_boundary_transport_step(setup):
    cfg, j, t = setup
    key = jax.random.fold_in(jax.random.key(0), 3)
    ref, rdiag = jax.jit(lambda a, k: jtransport.transport_step(
        a, j["diag"].probs, j["diag"].xkhh, j["exch"], j["grid"], cfg, cfg.dynamics.dt, k,
        return_diag=True, rho3=j["rho3"], dz3=j["dz3"]))(j["aero"], key)
    out, diag = transport.transport_step(t["aero"], t["diag"].probs, t["diag"].xkhh,
                                         t["exch"], make_grid(cfg), cfg, cfg.dynamics.dt,
                                         kd(key), rho3=t["rho3"], dz3=t["dz3"])
    for k in ("overflow_class", "overflow_free", "movers"):
        assert float(diag[k]) == float(rdiag[k]), k
    ref = jax.tree.map(np.asarray, ref)
    assert_aero_equal(ref, to_numpy(out))
    # particles left the domain: the represented number fell
    assert ref.num.sum() < np.asarray(j["aero"].num).sum() * (1.0 - 1e-4)


def test_open_boundary_probabilities(setup):
    """Clamped face averages of the eddy-diffusion probabilities, no
    arrivals from outside the domain in the preweight acceptance, and the
    drop mask of movers across an open edge."""
    cfg, j, t = setup
    grid = make_grid(cfg)
    dt = cfg.dynamics.dt
    ref_h = jtransport.horizontal_diffusion_probs(j["diag"].xkhh, j["grid"], dt,
                                                  rho3=j["rho3"], cfg=cfg)
    out_h = transport.horizontal_diffusion_probs(t["diag"].xkhh, grid, dt, t["rho3"], cfg)
    for a, b in zip(out_h, ref_h):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0.0)
    ph_ref = jtransport.normalized_face_probs(j["diag"].probs, ref_h)
    R_ref = jtransport.vertical_operator(j["diag"].probs, None, j["exch"], j["grid"], cfg, dt,
                                         rho3=j["rho3"], dz3=j["dz3"])
    acc_ref = jtransport.preweight_acceptance(j["aero"], ph_ref, R_ref, j["grid"], cfg)
    ph = transport.normalized_face_probs(t["diag"].probs, out_h)
    R = transport.vertical_operator(t["diag"].probs, t["exch"], grid, dt, t["rho3"], t["dz3"])
    acc = transport.preweight_acceptance(t["aero"], ph, R, cfg)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_ref), rtol=1e-5)
    key = jax.random.key(7)
    mv_ref = jtransport.sample_moves(j["aero"], ph_ref, R_ref, cfg.n_class, key)
    drop_ref = np.asarray(jtransport.open_boundary_drop(mv_ref[0], mv_ref[1], mv_ref[3],
                                                        j["grid"], cfg))
    dj, di, _, horiz = (torch.tensor(np.asarray(a)) for a in mv_ref)
    drop = transport.open_boundary_drop(dj, di, horiz, cfg).numpy()
    np.testing.assert_array_equal(drop, drop_ref)
    assert drop.any() and not drop[:, 1:-1, 1:-1].any()


@pytest.mark.parametrize("open_bc", [True, False], ids=["open", "periodic"])
def test_edge_movers_do_not_wrap(setup, open_bc):
    """``_reorder_minis`` shifts horizontal movers one column with a
    wrapping roll.  On an open axis that is right only because the movers
    across the edge were dropped first: every particle of the west column
    sent west leaves the domain (open), and arrives in the east column only
    when the axis is periodic.  Port and reference agree either way."""
    cfg, j, t = setup
    cfg = cfg if open_bc else cfg.replace(boundary=BoundaryConfig())
    a = jax.tree.map(np.asarray, j["aero"])
    west = (np.arange(12) == 0)[None, None, :, None]
    a = dataclasses.replace(a, num=np.where(west, a.num, 0.0).astype(np.float32),
                            vol=np.where(west[..., None, :], a.vol, 0.0).astype(np.float32))
    shp = a.num.shape
    di = np.full(shp, -1, np.int32)
    dj = np.zeros(shp, np.int32)
    horiz = np.ones(shp, bool)
    dest_k = np.broadcast_to(np.arange(4).reshape(-1, 1, 1, 1), shp).astype(np.int32)
    acc = np.ones(shp[:-1], np.float32)
    key = jax.random.key(8)
    drop_ref = jtransport.open_boundary_drop(dj, di, horiz, j["grid"], cfg)
    ref, _ = jax.jit(lambda aa: jtransport.rebucket(aa, dest_k, dj, di, horiz, drop_ref, acc,
                                                    j["grid"], cfg, key))(a)
    T = lambda x: torch.tensor(np.asarray(x))
    drop = transport.open_boundary_drop(T(dj), T(di), T(horiz), cfg)
    out, _ = transport.rebucket(from_numpy(a), T(dest_k), T(dj), T(di), T(horiz), drop,
                                T(acc), cfg, kd(key))
    ref, out = jax.tree.map(np.asarray, ref), to_numpy(out)
    assert_aero_equal(ref, out)
    n_west = a.num.sum()
    if open_bc:
        assert out.num.sum() == 0.0
    else:
        east = out.num[:, :, -1].sum()
        np.testing.assert_allclose(east, n_west, rtol=1e-6)
