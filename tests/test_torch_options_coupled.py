"""One coupled step of each new option set of the port against the JAX
package's ``coupled_step`` on the CPU:

- mesoscale at 12x12x10, 16 particles per cell (capacity 32): YSU + slab
  LSM + Dudhia/gray radiation, WSM5, BMJ and sea salt on the runner's
  em_uniform model with its humid sounding;
- LES at 12x12x8, 16 per cell (capacity 32): TKE (km_opt=2, diff_opt=2),
  NBA (sfs_opt=1), WENO5/WENO3 and Kessler from ``tests/test_les.py``'s
  warm bubble, without emission.

Both sets are ``option_sets.py``'s (``option_config``, built by
``build_option_set`` through the port's ``run.build_model``).  The JAX side
is the JAX package's ``run.build_model`` with the port's ``Config`` and the
same initial dycore state; the port's initial state must equal it.
One step is compared as ``tests/test_torch_cares_coupled.py`` does: dycore
fields rtol 1e-4 with an absolute floor of 1e-4 of each field's scale
(w and ph roundoff-sized; 5e-4 in the LES, whose weak bubble leaves the
reference's own jit-against-eager spread of one dycore step at 3.8e-4 of
the scale of p', 2.4e-4 of mu' and 1.0e-4 of w); per cell the alive mask slot for slot, the
represented number rtol 1e-5 and the per-species volume rtol 1e-4 with a
floor of 1e-6 of the largest; the slab LSM's skin and deep-soil temperatures
rtol 1e-5.  The step's gates sit away from their thresholds on these
inputs (checked on the reference's state: BMJ's CAPE and depth, and every
level's bulk Richardson number against the PBL's ``rib_crit``), so no
draw or switch flips and the comparison is particle for particle.  The
em_uniform blob's tails fall to 1e-14 of its peak, where the monotonic
limiter's outflow probabilities are round-off (0.15 in one framework and 1.0
in the other): the mesoscale step starts from the reference's state with
every particle's number lifted to at least 1e-6 of the largest.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu import config as jconfig
from wrf_partmc_tpu.models.coupled.driver import coupled_step
from wrf_partmc_tpu.models.dycore import solve as jsolve
from wrf_partmc_tpu.models.dycore.ideal import init_warm_bubble_arw
from wrf_partmc_tpu.models.dycore.state import temperature as jax_temperature
from wrf_partmc_tpu.models.dycore.state import total_pressure as jax_total_pressure
from wrf_partmc_tpu.models.physics import cumulus as jcumulus
from wrf_partmc_tpu.run import build_model as jax_build_model
from wrf_partmc_tpu.utils import rng as jrng

from wrf_partmc_tpu_torch import option_sets
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy

N_PART, CAP = 16, 32


def _jax_mesoscale(cfg):
    jcfg = config_from_reference(cfg, jconfig.Config)
    grid, ad, gd, scn, cs, exch, _ = jax_build_model(jcfg, "uniform", 0)
    host = jax.tree.map(np.asarray, cs)
    dyn = option_sets.humid_sounding(from_numpy(host.dyn),
                                     from_numpy(jax.tree.map(np.asarray, grid)))
    cs = dataclasses.replace(cs, dyn=dataclasses.replace(
        cs.dyn, moist=jnp.asarray(dyn.moist.numpy())))
    return jcfg, grid, ad, gd, scn, cs, exch


def _jax_les(cfg):
    jcfg = config_from_reference(cfg, jconfig.Config)
    grid, ad, gd, scn, cs, exch, _ = jax_build_model(jcfg, "warm_bubble", 0)
    s = init_warm_bubble_arw(jcfg, grid, d_theta=1.0, z_center=150.0, z_radius=120.0)
    kk = jax.random.normal(jax.random.key(0), (2, grid.ny, grid.nx)) * 0.2
    s = dataclasses.replace(s, theta_p=s.theta_p.at[:2].add(kk))
    return jcfg, grid, ad, gd, scn, dataclasses.replace(cs, dyn=s), exch


SETS = {"mesoscale": ((12, 12, 10), _jax_mesoscale), "les": ((12, 12, 8), _jax_les)}


@pytest.fixture(scope="module")
def stepped_sets():
    """name -> the set's port model, its and the reference's initial states
    and their steps, the reference's diag and grid.  Each reference step
    compiles in a thread of its own, beside the next set's tracing and the
    port's steps."""
    built = {}
    with concurrent.futures.ThreadPoolExecutor(len(SETS)) as pool:
        for name in sorted(SETS):
            shape, jax_build = SETS[name]
            model, state = option_sets.build_option_set(name, *shape, N_PART, CAP, device="cpu")
            jcfg, grid, ad, gd, scn, cs, exch = jax_build(model.cfg)
            key = jrng.base_key(0)
            j0 = jax.tree.map(np.asarray, cs)
            if name == "mesoscale":
                num = cs.aero.num
                cs = dataclasses.replace(cs, aero=dataclasses.replace(
                    cs.aero, num=jnp.where(num > 0, jnp.maximum(num, 1e-6 * num.max()), 0.0)))
            step = pool.submit(jax.jit(lambda c: coupled_step(
                c, grid, jcfg, ad, gd, scn, exch, key, diag_out=True)).lower(cs).compile)
            built[name] = (model, state, cs, j0, step, grid)
        out = {}
        for name, (model, state, cs, j0, step, grid) in built.items():
            t0 = to_numpy(state)
            # the port steps the reference's initial state (its own differs in
            # the last ulp of the exponentials, test_same_config_and_initial_state)
            t1 = to_numpy(model(from_numpy(jax.tree.map(np.asarray, cs))))
            j1, jdiag = jax.tree.map(np.asarray, step.result()(cs))
            out[name] = (name, model, (j0, t0), (j1, t1), jdiag, grid)
    return out


@pytest.fixture(scope="module", params=sorted(SETS))
def stepped(request, stepped_sets):
    return stepped_sets[request.param]


def test_same_config_and_initial_state(stepped):
    name, model, (j0, t0), _, _, _ = stepped
    d = model.cfg.dynamics
    if name == "mesoscale":
        assert (d.bl_physics, d.sf_surface_physics, d.ra_physics, d.mp_physics,
                d.cu_physics, model.cfg.partmc.seasalt_param, model.cfg.n_moist) == (
            1, 1, 1, 2, 2, 1, 5)
    else:
        assert (d.diff_opt, d.km_opt, d.sfs_opt, d.h_adv_order, d.v_adv_order,
                d.mp_physics, model.cfg.partmc.do_emission) == (
            2, 2, 1, "weno5", "weno3", 1, False)
    for f in dataclasses.fields(j0.dyn):
        a = getattr(j0.dyn, f.name)
        if a is None:
            continue
        if name == "les" and f.name == "theta_p":
            # bubble plus noise: each term within an ulp, their sum where
            # they cancel within 2 ulp of the field's largest value
            np.testing.assert_allclose(t0.dyn.theta_p, a, rtol=0.0,
                                       atol=2 * np.spacing(np.abs(a).max()))
        else:
            np.testing.assert_array_max_ulp(getattr(t0.dyn, f.name), a, 2)
    np.testing.assert_array_equal(t0.aero.num > 0, j0.aero.num > 0)
    np.testing.assert_allclose(t0.aero.num, j0.aero.num, rtol=1e-5)
    np.testing.assert_allclose(t0.aero.vol, j0.aero.vol, rtol=1e-5, atol=0.0)
    for f in ("source", "w_class", "pid", "next_id"):
        np.testing.assert_array_equal(getattr(t0.aero, f), getattr(j0.aero, f), err_msg=f)
    assert int((t0.aero.num > 0).sum()) > 0


def test_gates_clear(stepped):
    """On the reference's state after the step: the PBL's bulk Richardson
    numbers and BMJ's CAPE and depth (mesoscale), the TKE closure's N^2
    against its 1e-10 switch of the length scale (LES), are away from their
    thresholds."""
    name, model, (j0, _), (j1, _), _, grid = stepped
    dyn = jax.tree.map(jnp.asarray, j1.dyn)
    if name == "les":
        n2 = np.asarray(jsolve.brunt_vaisala_sq(dyn, grid))
        assert np.abs(n2 / 1e-10 - 1.0).min() > 0.01
        return
    temp = np.asarray(jax_temperature(dyn, grid))
    pres = np.asarray(jax_total_pressure(dyn, grid))
    tp = np.asarray(jcumulus._parcel_profile(temp, j1.dyn.moist[0], pres))
    buoy = (tp - temp) / temp
    dz = (np.diff(np.asarray(grid.phb), axis=0) + np.diff(j1.dyn.ph, axis=0)) / 9.81
    cape = (np.maximum(buoy, 0.0) * 9.81 * dz).sum(0)
    top = np.where(buoy > 0.0, np.cumsum(dz, axis=0) - 0.5 * dz, 0.0).max(0)
    assert cape.min() > 3 * jcumulus.CAPE_MIN and top.min() > jcumulus.MIN_DEPTH + 1000.0
    theta = np.asarray(grid.t_base).reshape(-1, 1, 1) + j1.dyn.theta_p
    u3 = 0.5 * (j1.dyn.u + np.roll(j1.dyn.u, -1, axis=-1))
    v3 = 0.5 * (j1.dyn.v + np.roll(j1.dyn.v, -1, axis=-2))
    zc = np.asarray(grid.z_half).reshape(-1, 1, 1)
    thv_s = theta[0] + 0.5
    rib = 9.81 * zc * (theta - thv_s) / (thv_s * np.maximum(u3 * u3 + v3 * v3, 0.25))
    assert np.abs(rib / 0.25 - 1.0).min() > 0.01


ATOL = {"w": 1e-5, "ph": 1e-3}


@pytest.mark.parametrize("field", ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist",
                                   "chem", "num_conc", "tke"])
def test_one_step_dycore(stepped, field):
    name, _, _, (j1, t1), _, _ = stepped
    ref, out = getattr(j1.dyn, field), getattr(t1.dyn, field)
    assert out.shape == ref.shape
    floor = 5e-4 if name == "les" else 1e-4
    atol = max(ATOL.get(field, 0.0), floor * float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=atol)


def test_one_step_particles_per_cell(stepped):
    _, _, (j0, _), (j1, t1), _, _ = stepped
    ja, ta = j1.aero, t1.aero
    np.testing.assert_array_equal(ta.num > 0, ja.num > 0)
    np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
    for f in ("source", "w_class", "next_id"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f), err_msg=f)
    assert t1.step == int(j1.step) == 1


def test_one_step_physics_ran(stepped):
    """The options did something: sea salt at level 0, WSM5 ice, the slab
    LSM (mesoscale); the TKE and the WENO-advected tracers (LES)."""
    name, model, (j0, _), (j1, t1), _, _ = stepped
    if name == "mesoscale":
        i_na = model.aero_data.spec_by_name("Na")
        na = (t1.aero.vol[..., i_na, :] > 0) & (t1.aero.num > 0)
        assert na[0].sum() > 0
        assert t1.dyn.moist[3].max() > 1e-6                   # ice
        np.testing.assert_allclose(t1.land.tsk, j1.land.tsk, rtol=1e-5)
        np.testing.assert_allclose(t1.land.t_deep, j1.land.t_deep, rtol=1e-5)
        assert np.abs(j1.land.tsk - j0.land.tsk).max() > 1e-3
    else:
        assert np.abs(j1.dyn.tke - j0.dyn.tke).max() > 1e-5
        assert np.abs(j1.dyn.num_conc - j0.dyn.num_conc).max() > 0.0


def test_one_step_transport_counters(stepped):
    _, model, _, _, jdiag, _ = stepped
    for k in ("overflow_class", "overflow_free", "movers"):
        np.testing.assert_allclose(float(model.last_diag[k]), float(jdiag[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(SETS))
def test_default_device_is_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        option_sets.build_option_set(name, 6, 6, 4, n_part=4, cap=8)
