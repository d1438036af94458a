"""The CARES physics of the port against the JAX functions under
``jax.jit``: the MYJ surface layer and TKE PBL, Morrison microphysics with
graupel, Grell cumulus, the radiation schemes, the land-use tables and the
Noah and slab land-surface models.

Inputs are made from a seed with numpy on a 6x5x12 column set (16 km top,
the CARES vertical extent): a warm-bubble ARW base state with random
moisture, hydrometeors, winds and surface forcing.  The two frameworks
round transcendentals (exp, log, pow, lgamma) differently in the last ulp,
so fields are held at rtol 1e-4 with an absolute floor of 1e-5 of each
field's scale unless a test says otherwise.  Threshold switches (the Grell
trigger ``A_MIN``, Morrison's cold/warm and conversion gates) are compared
in regimes where the reference's own jit and eager runs agree to the same
tolerance, which the tests check before they compare the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.config import Config, DomainConfig, DynamicsConfig
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.dycore.ideal import init_warm_bubble_arw
from wrf_partmc_tpu.models.dycore.state import temperature as jax_temperature
from wrf_partmc_tpu.models.dycore.state import total_pressure as jax_total_pressure
from wrf_partmc_tpu.models.physics import grell as jgrell
from wrf_partmc_tpu.models.physics import landuse as jlanduse
from wrf_partmc_tpu.models.physics import lsm as jlsm
from wrf_partmc_tpu.models.physics import morrison as jmorrison
from wrf_partmc_tpu.models.physics import myj as jmyj
from wrf_partmc_tpu.models.physics import radiation as jrad
from wrf_partmc_tpu.models.physics.thermo import saturation_mixing_ratio as jax_qsat

from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.physics import grell, landuse, lsm, morrison, myj, radiation

NZ, NY, NX = 12, 5, 6


def close(out, ref, rtol=1e-4, floor=1e-5, err_msg=""):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=floor * (float(np.abs(ref).max()) + 1e-30),
                               err_msg=err_msg)


def T(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    cfg = Config(domain=DomainConfig(nx=NX, ny=NY, nz=NZ, dx=4000.0, dy=4000.0,
                                     ztop=16000.0),
                 dynamics=DynamicsConfig(dt=30.0, dyn_opt="arw", mp_physics=10,
                                         cu_physics=5, bl_physics=2),
                 n_moist=10, n_moist_mass=6)
    jgrid = jax_make_grid(cfg)
    r = np.random.default_rng(0)
    s = jax.tree.map(np.asarray, init_warm_bubble_arw(cfg, jgrid, d_theta=1.5))
    temp = np.asarray(jax_temperature(s, jgrid))
    qs = np.asarray(jax_qsat(temp, np.asarray(jax_total_pressure(s, jgrid))))
    kk = np.arange(NZ).reshape(-1, 1, 1)
    moist = np.zeros_like(s.moist)
    moist[0] = qs * r.uniform(0.6, 1.05, qs.shape)                # qv
    scale = np.where(kk < 6, 1.0, 0.2)
    moist[1] = 2e-4 * scale * r.random(qs.shape)                  # qc
    moist[2] = 1e-4 * scale * r.random(qs.shape)                  # qr
    moist[3] = 5e-5 * (1.2 - scale) * r.random(qs.shape)          # qi
    moist[4] = 8e-5 * (1.2 - scale) * r.random(qs.shape)          # qs
    moist[5] = 4e-5 * (1.2 - scale) * r.random(qs.shape)          # qg
    moist[6] = 1e4 * r.uniform(0.5, 2.0, qs.shape)                # nr
    moist[7] = 1e5 * r.uniform(0.5, 2.0, qs.shape)                # ni
    moist[8] = 1e4 * r.uniform(0.5, 2.0, qs.shape)                # ns
    moist[9] = 1e3 * r.uniform(0.5, 2.0, qs.shape)                # ng
    s = dataclasses.replace(
        s, moist=moist.astype(np.float32),
        u=r.normal(5.0, 3.0, s.u.shape).astype(np.float32),
        v=r.normal(0.0, 3.0, s.v.shape).astype(np.float32))
    return cfg, jgrid, make_grid(config_from_reference(cfg)), s, temp


# ---- MYJ ------------------------------------------------------------------

def test_level25_stability():
    gh = np.linspace(-0.5, 0.05, 41).astype(np.float32)
    ref = jax.jit(jmyj.level25_stability)(gh, gh)
    out = myj.level25_stability(T(gh), T(gh))
    for o, rr in zip(out, ref):
        close(o, rr, rtol=1e-6, floor=0.0)


@pytest.mark.parametrize("regime", ["unstable", "stable"])
def test_myj_surface_layer(regime):
    r = np.random.default_rng(1)
    u1, v1 = (r.normal(0.0, 6.0, (NY, NX)).astype(np.float32) for _ in range(2))
    th1 = r.uniform(290.0, 300.0, (NY, NX)).astype(np.float32)
    d = r.uniform(0.5, 4.0, (NY, NX)).astype(np.float32)
    thsfc = th1 + d if regime == "unstable" else th1 - d
    ref = jax.jit(lambda *a: jmyj.myj_surface_layer(*a, jnp.float32(60.0), z0=0.1))(
        u1, v1, th1, thsfc)
    out = myj.myj_surface_layer(T(u1), T(v1), T(th1), T(thsfc), torch.tensor(60.0), z0=0.1)
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k], err_msg=k)
    assert (np.asarray(ref["rmol"]) < 0).all() == (regime == "unstable")


def test_myj_tke_step_and_pbl_height(setup):
    cfg, jgrid, grid, s, _ = setup
    r = np.random.default_rng(2)
    theta = (np.asarray(jgrid.t_base).reshape(-1, 1, 1) + s.theta_p
             + np.linspace(-1.0, 6.0, NZ).reshape(-1, 1, 1)
             + r.normal(0.0, 0.3, s.theta_p.shape)).astype(np.float32)
    q2 = r.uniform(0.02, 3.0, (NZ + 1, NY, NX)).astype(np.float32)
    ustar = r.uniform(0.05, 0.8, (NY, NX)).astype(np.float32)
    ref = jax.jit(lambda q, th, u, v, us: jmyj.myj_tke_step(q, th, u, v, jgrid, us, 30.0))(
        q2, theta, s.u, s.v, ustar)
    out = myj.myj_tke_step(T(q2), T(theta), T(s.u), T(s.v), grid, T(ustar), 30.0)
    for o, rr, name in zip(out, ref, ("q2", "exch_h", "exch_m")):
        close(o, rr, err_msg=name)
    assert np.asarray(ref[1]).max() > 1.0                  # mixing is active
    h_ref = jax.jit(lambda q: jmyj.tke_pbl_height(q, jgrid))(ref[0])
    close(myj.tke_pbl_height(out[0], grid), h_ref, rtol=1e-6, floor=0.0)
    close(myj.init_q2(grid), jmyj.init_q2(jgrid), rtol=0.0, floor=0.0)


# ---- Morrison -------------------------------------------------------------

def test_morrison_step(setup):
    cfg, jgrid, grid, s, temp = setup
    # both sides of the freezing level and of ice saturation are present,
    # and no cell sits within 0.05 K of 0 C, where the cold gate switches
    assert (temp < 273.15).any() and (temp > 273.15).any()
    assert np.abs(temp - 273.15).min() > 0.05
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda st: jmorrison.morrison_step(st, jgrid, 30.0))(s))
    eager = jax.tree.map(np.asarray, jmorrison.morrison_step(
        jax.tree.map(jnp.asarray, s), jgrid, 30.0))
    out = to_numpy(morrison.morrison_step(from_numpy(s), grid, 30.0))
    close(out.theta_p, ref.theta_p)
    for i in range(10):
        # the reference's own jit-vs-eager spread is inside the tolerance
        close(eager.moist[i], ref.moist[i], rtol=2e-4, err_msg=f"eager moist[{i}]")
        close(out.moist[i], ref.moist[i], rtol=2e-4, err_msg=f"moist[{i}]")
    moved = np.abs(ref.moist - s.moist).max(axis=(1, 2, 3)) / np.abs(s.moist).max(axis=(1, 2, 3))
    assert (moved > 1e-3).all(), moved                     # every species evolved


def test_morrison_without_graupel(setup):
    """The 8-row moist family (no graupel): frozen rain goes to snow."""
    cfg, jgrid, grid, s, _ = setup
    s8 = dataclasses.replace(s, moist=np.concatenate([s.moist[:5], s.moist[6:9]]))
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda st: jmorrison.morrison_step(st, jgrid, 30.0))(s8))
    out = to_numpy(morrison.morrison_step(from_numpy(s8), grid, 30.0))
    close(out.theta_p, ref.theta_p)
    for i in range(8):
        close(out.moist[i], ref.moist[i], rtol=2e-4, err_msg=f"moist[{i}]")


# ---- Grell ----------------------------------------------------------------

def _convective(s, jgrid, temp, rh):
    """A moist, warm boundary layer under a dry free troposphere (the JAX
    package's own Grell test state), rh the boundary-layer humidity."""
    qs = np.asarray(jax_qsat(temp, np.asarray(jax_total_pressure(s, jgrid))))
    kk = np.arange(NZ).reshape(-1, 1, 1)
    qv = np.where(kk < 4, rh * qs, 0.1 * qs).astype(np.float32)
    return dataclasses.replace(s, theta_p=(s.theta_p + np.where(kk < 2, 4.0, 0.0)
                                           ).astype(np.float32),
                               moist=np.concatenate([qv[None], s.moist[1:]]))


@pytest.mark.parametrize("rh", [0.95, 0.3], ids=["deep", "suppressed"])
def test_grell_step(setup, rh):
    cfg, jgrid, grid, s, temp = setup
    sc = _convective(s, jgrid, temp, rh)
    ref, rain_ref = jax.tree.map(np.asarray, jax.jit(
        lambda st: jgrell.grell_step(st, jgrid, 30.0))(sc))
    eager, _ = jax.tree.map(np.asarray, jgrell.grell_step(
        jax.tree.map(jnp.asarray, sc), jgrid, 30.0))
    close(eager.theta_p, ref.theta_p)       # no trigger flips between jit and eager
    out, rain = grell.grell_step(from_numpy(sc), grid, 30.0)
    out = to_numpy(out)
    close(out.theta_p, ref.theta_p)
    close(out.moist[0], ref.moist[0])
    close(rain, rain_ref)
    np.testing.assert_array_equal(out.moist[1:], sc.moist[1:])
    assert (rain_ref.max() > 1e-6) == (rh > 0.5)


# ---- radiation ------------------------------------------------------------

def _column_inputs(setup):
    cfg, jgrid, grid, s, temp = setup
    r = np.random.default_rng(3)
    rho = (1.2 * np.exp(-np.asarray(jgrid.z_half) / 8000.0)).reshape(-1, 1, 1) \
        * r.uniform(0.98, 1.02, temp.shape)
    optics = [r.uniform(0.0, 0.05, (4,) + temp.shape), r.uniform(0.8, 0.99, (4,) + temp.shape),
              r.uniform(0.5, 0.75, (4,) + temp.shape)]
    t_sfc = temp[0] + r.uniform(-2.0, 4.0, temp.shape[1:])
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(temp), f32(s.moist[0]), f32(rho), np.asarray(jgrid.dz), f32(t_sfc),
            [f32(o) for o in optics])


@pytest.mark.parametrize("scheme", ["dudhia", "kdist"])
@pytest.mark.parametrize("aerosol", [False, True], ids=["clear", "aerosol"])
def test_shortwave(setup, scheme, aerosol):
    temp, qv, rho, dz, _, opt = _column_inputs(setup)
    jfn = jrad.shortwave_kdist if scheme == "kdist" else jrad.shortwave
    fn = radiation.shortwave_kdist if scheme == "kdist" else radiation.shortwave
    a = opt if aerosol else [None] * 3
    ref = jax.jit(lambda q, r_, *o: jfn(q, r_, dz, jnp.float32(0.7), 0.2, *o))(qv, rho, *a)
    out = fn(T(qv), T(rho), T(dz), torch.tensor(0.7), 0.2,
             *[T(o) if o is not None else None for o in a])
    close(out[0], ref[0], err_msg="heating")
    close(out[1], ref[1], err_msg="surface down")
    assert np.asarray(ref[0]).max() > 0.0


@pytest.mark.parametrize("scheme", ["gray", "kdist"])
def test_longwave(setup, scheme):
    temp, qv, rho, dz, t_sfc, _ = _column_inputs(setup)
    jfn = jrad.longwave_kdist if scheme == "kdist" else jrad.longwave
    fn = radiation.longwave_kdist if scheme == "kdist" else radiation.longwave
    ref = jax.jit(lambda *a: jfn(*a))(temp, qv, rho, dz, t_sfc)
    out = fn(T(temp), T(qv), T(rho), T(dz), T(t_sfc))
    for o, rr, name in zip(out, ref, ("heating", "surface down", "olr")):
        close(o, rr, err_msg=name)


@pytest.mark.parametrize("cosz", [0.7, -0.2], ids=["day", "night"])
def test_radiation_driver_and_photolysis_factor(setup, cosz):
    from wrf_partmc_tpu.models.partmc.optics import BulkOptics as JBulk
    from wrf_partmc_tpu_torch.models.partmc.optics import BulkOptics

    temp, qv, rho, dz, t_sfc, opt = _column_inputs(setup)
    ref = jax.jit(lambda *a: jrad.radiation_driver(
        a[0], a[1], a[2], dz, jnp.float32(cosz), t_sfc=a[3], optics=JBulk(*a[4:]),
        lw_scheme="kdist", sw_scheme="kdist"))(temp, qv, rho, t_sfc, *opt)
    out = radiation.radiation_driver(T(temp), T(qv), T(rho), T(dz), torch.tensor(cosz),
                                     t_sfc=T(t_sfc), optics=BulkOptics(*map(T, opt)),
                                     lw_scheme="kdist", sw_scheme="kdist")
    close(out[0], ref[0], err_msg="heating")
    for k in ref[1]:
        close(out[1][k], ref[1][k], err_msg=k)
    jf = jax.jit(lambda *o: jrad.photolysis_aerosol_factor(*o, jnp.float32(cosz)))(*opt)
    f = radiation.photolysis_aerosol_factor(*map(T, opt), torch.tensor(cosz))
    close(f, jf, rtol=1e-5)
    jf = np.asarray(jf)
    assert jf.max() <= 1.0 and (jf.min() > 0.0 or cosz < 0.0)


# ---- land use and land surface --------------------------------------------

@pytest.mark.parametrize("season", ["summer", "winter"])
def test_landuse_tables(season):
    r = np.random.default_rng(4)
    iv = r.integers(-1, 27, (NY, NX)).astype(np.int32)      # out-of-range clamps
    isl = r.integers(0, 14, (NY, NX)).astype(np.int32)
    ref = jlanduse.noah_params(iv, isl, season)
    out = landuse.noah_params(T(iv), T(isl), season)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


def _lsm_forcing(setup):
    cfg, jgrid, grid, s, temp = setup
    r = np.random.default_rng(5)
    f32 = lambda a: np.asarray(a, np.float32)
    exner = f32((np.asarray(jgrid.pb3[0]) / 1.0e5) ** (287.0 / 1004.0))
    return dict(sw_dn=f32(r.uniform(0.0, 800.0, (NY, NX))),
                lw_dn=f32(r.uniform(280.0, 380.0, (NY, NX))),
                temp1=f32(temp[0]), qv1=f32(s.moist[0][0]),
                rho1=f32(r.uniform(1.1, 1.2, (NY, NX))),
                ustar=f32(r.uniform(0.05, 0.6, (NY, NX))), exner_sfc=exner,
                th1=f32(temp[0] / exner))


@pytest.mark.parametrize("season", ["summer", "winter"])
def test_noah_lsm_step(setup, season):
    r = np.random.default_rng(6)
    iv = r.integers(1, 25, (NY, NX)).astype(np.int32)
    isl = r.integers(1, 13, (NY, NX)).astype(np.int32)
    jland = jax.tree.map(np.asarray, jlsm.init_noah(NY, NX, 292.0, tbot=289.0,
                                                     sm0=None, ivgtyp=iv, isltyp=isl))
    land = lsm.init_noah(NY, NX, 292.0, tbot=289.0, sm0=None, ivgtyp=iv, isltyp=isl)
    for f in ("tsk", "t_soil", "smois", "tbot", "ivgtyp", "isltyp"):
        np.testing.assert_array_equal(getattr(land, f).numpy(), getattr(jland, f), err_msg=f)
    jland = dataclasses.replace(jland, smois=(jland.smois * r.uniform(
        0.5, 1.3, jland.smois.shape)).astype(np.float32),
        tsk=(jland.tsk + r.uniform(-3.0, 3.0, jland.tsk.shape)).astype(np.float32))
    frc = _lsm_forcing(setup)
    ref = jax.tree.map(np.asarray, jax.jit(lambda ld, f: jlsm.noah_lsm_step(
        ld, **f, dt=30.0, season=season))(jland, frc))
    out = lsm.noah_lsm_step(from_numpy(jland), **{k: T(v) for k, v in frc.items()},
                            dt=30.0, season=season)
    for f in ("tsk", "t_soil", "smois"):
        close(getattr(out[0], f), getattr(ref[0], f), rtol=1e-5, err_msg=f)
    for k in ref[1]:
        close(out[1][k], ref[1][k], err_msg=k)
    assert np.abs(ref[0].t_soil - jland.t_soil).max() > 1e-4       # soil heat moved


def test_slab_lsm_step(setup):
    jland = jax.tree.map(np.asarray, jlsm.init_land(NY, NX, 293.0))
    land = lsm.init_land(NY, NX, 293.0)
    np.testing.assert_array_equal(land.tsk.numpy(), jland.tsk)
    frc = _lsm_forcing(setup)
    ref = jax.tree.map(np.asarray, jax.jit(lambda ld, f: jlsm.slab_lsm_step(
        ld, **f, dt=30.0))(jland, frc))
    out = lsm.slab_lsm_step(land, **{k: T(v) for k, v in frc.items()}, dt=30.0)
    for f in ("tsk", "t_deep"):
        close(getattr(out[0], f), getattr(ref[0], f), rtol=1e-6, err_msg=f)
    for k in ref[1]:
        close(out[1][k], ref[1][k], err_msg=k)
