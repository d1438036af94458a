"""The port's YSU, BMJ, Kessler, WSM5 and single-column forcing against the
JAX functions under ``jax.jit``: the Businger-Dyer functions, the surface
layer, the bulk-Richardson PBL height, the YSU exch_h, the BMJ adjustment,
the Kessler and WSM5 steps and ``scm_forcing``.

Inputs are made from a seed with numpy on a 6x5x12 column set (16 km top):
a warm-bubble ARW base state with random moisture, hydrometeors and winds.
Fields are held at rtol 1e-4 with an absolute floor of 1e-5 of each
field's scale unless a test says otherwise (XLA-CPU and torch round exp,
log and pow differently in the last ulp; the surface layer's five
fixed-point iterations and the parcel's Newton steps carry that further).
Threshold switches are checked to sit away from the test inputs before the
outputs are compared: the bulk Richardson number against ``rib_crit``,
BMJ's CAPE, depth, cloud-edge and rain gates, and the microphysics'
0 C and homogeneous-freezing gates; the microphysics are held at the
reference's own jit-vs-eager spread, which each test measures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu import constants as jc
from wrf_partmc_tpu.config import Config, DomainConfig, DynamicsConfig
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.dycore.ideal import init_warm_bubble_arw
from wrf_partmc_tpu.models.dycore.state import temperature as jax_temperature
from wrf_partmc_tpu.models.dycore.state import total_pressure as jax_total_pressure
from wrf_partmc_tpu.models.physics import cumulus as jcumulus
from wrf_partmc_tpu.models.physics import microphysics as jmicro
from wrf_partmc_tpu.models.physics import scm_forcing as jscm
from wrf_partmc_tpu.models.physics import surface as jsurface
from wrf_partmc_tpu.models.physics.thermo import saturation_mixing_ratio as jax_qsat

from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.physics import cumulus, microphysics, scm_forcing, surface

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


def _cfg(n_moist):
    return Config(domain=DomainConfig(nx=NX, ny=NY, nz=NZ, dx=4000.0, dy=4000.0,
                                      ztop=16000.0),
                  dynamics=DynamicsConfig(dt=30.0, dyn_opt="arw", mp_physics=2,
                                          cu_physics=2, bl_physics=1),
                  n_moist=n_moist)


@pytest.fixture(scope="module")
def setup():
    """(jax grid, port grid, 5-species state, temperature)."""
    cfg = _cfg(5)
    jgrid = jax_make_grid(cfg)
    r = np.random.default_rng(0)
    s = jax.tree.map(np.asarray, init_warm_bubble_arw(cfg, jgrid, d_theta=1.5))
    temp = np.asarray(jax_temperature(s, jgrid))
    qs = np.asarray(jax_qsat(temp, np.asarray(jax_total_pressure(s, jgrid))))
    kk = np.arange(NZ).reshape(-1, 1, 1)
    low = np.where(kk < 6, 1.0, 0.2)
    moist = np.zeros_like(s.moist)
    moist[0] = qs * r.uniform(0.6, 1.1, qs.shape)
    moist[1] = 1.5e-3 * low * r.random(qs.shape)       # qc, above QC0 in places
    moist[2] = 2e-4 * low * r.random(qs.shape)
    moist[3] = 3e-4 * (1.2 - low) * r.random(qs.shape)  # qi, above QI0_AUTO in places
    moist[4] = 1e-4 * (1.2 - low) * r.random(qs.shape)
    s = dataclasses.replace(
        s, moist=moist.astype(np.float32),
        u=r.normal(5.0, 3.0, s.u.shape).astype(np.float32),
        v=r.normal(0.0, 3.0, s.v.shape).astype(np.float32))
    return jgrid, make_grid(config_from_reference(cfg)), s, temp


# ---- surface layer and YSU --------------------------------------------------

def test_stability_functions():
    zeta = np.linspace(-12.0, 12.0, 241).astype(np.float32)
    for name in ("psi_m", "psi_h", "_phi_m", "_phi_h"):
        ref = jax.jit(getattr(jsurface, name))(zeta)
        close(getattr(surface, name)(T(zeta)), ref, rtol=1e-5, floor=1e-6, err_msg=name)


def _sfc_inputs(regime, seed=1):
    r = np.random.default_rng(seed)
    u1, v1 = (r.normal(0.0, 6.0, (NY, NX)).astype(np.float32) for _ in range(2))
    th1 = r.uniform(290.0, 300.0, (NY, NX)).astype(np.float32)
    d = r.uniform(0.5, 4.0, (NY, NX)).astype(np.float32)
    return u1, v1, th1, (th1 + d if regime == "unstable" else th1 - d)


@pytest.mark.parametrize("regime", ["unstable", "stable"])
def test_surface_layer(regime):
    u1, v1, th1, thsfc = _sfc_inputs(regime)
    ref = jax.jit(lambda *a: jsurface.surface_layer(*a, jnp.float32(60.0), z0=0.1))(
        u1, v1, th1, thsfc)
    out = surface.surface_layer(T(u1), T(v1), T(th1), T(thsfc), torch.tensor(60.0), z0=0.1)
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k], err_msg=k)
    assert (np.asarray(ref["rmol"]) < 0).all() == (regime == "unstable")


def _column(jgrid, seed):
    """theta (stable above a mixed layer), u, v at half levels."""
    r = np.random.default_rng(seed)
    z = np.asarray(jgrid.z_half).reshape(-1, 1, 1)
    zi = r.uniform(800.0, 2500.0, (1, NY, NX))
    theta = (300.0 + 0.004 * np.maximum(z - zi, 0.0)
             + r.normal(0.0, 0.05, (NZ, NY, NX))).astype(np.float32)
    u = (r.normal(4.0, 2.0, (NZ, NY, NX)) + 0.002 * z).astype(np.float32)
    v = r.normal(0.0, 2.0, (NZ, NY, NX)).astype(np.float32)
    return theta, u, v


def test_pbl_height(setup):
    jgrid, grid, _, _ = setup
    theta, u, v = _column(jgrid, 3)
    # the Richardson gate: no level within 2% of rib_crit
    zc = np.asarray(jgrid.z_half).reshape(-1, 1, 1)
    thv_s = theta[0] + 0.5
    rib = 9.81 * zc * (theta - thv_s) / (thv_s * np.maximum(u * u + v * v, 0.25))
    assert np.abs(rib / 0.25 - 1.0).min() > 0.02
    ref = jax.jit(lambda *a: jsurface.pbl_height(a[0], jgrid.z_half, u=a[1], v=a[2]))(
        theta, u, v)
    out = surface.pbl_height(T(theta), grid.z_half, u=T(u), v=T(v))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert len(np.unique(np.asarray(ref))) > 1          # the height varies
    ref = jax.jit(lambda th: jsurface.pbl_height(th, jgrid.z_half))(theta)
    np.testing.assert_array_equal(surface.pbl_height(T(theta), grid.z_half).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("regime", ["unstable", "stable"])
@pytest.mark.parametrize("free", [False, True])
def test_ysu_exch_h(setup, regime, free):
    """Inside the PBL, and above it with the local free-atmosphere K."""
    jgrid, grid, _, _ = setup
    u1, v1, th1, thsfc = _sfc_inputs(regime, seed=4)
    sfc = jax.jit(lambda *a: jsurface.surface_layer(*a, jgrid.z_half[0]))(u1, v1, th1, thsfc)
    theta, u, v = _column(jgrid, 5)
    h = np.asarray(jsurface.pbl_height(theta, jgrid.z_half, u=u, v=v))
    kw = dict(hfx_kin=sfc["hfx_kin"])
    if free:
        kw.update(theta=theta, u=u, v=v)
    ref = jax.jit(lambda us, rm, hh, kw: jsurface.ysu_exch_h(jgrid, us, rm, hh, **kw))(
        sfc["ustar"], sfc["rmol"], h, kw)
    out = surface.ysu_exch_h(grid, T(sfc["ustar"]), T(sfc["rmol"]), T(h),
                             **{k: T(a) for k, a in kw.items()})
    close(out, ref)
    ref_np = np.asarray(ref)
    assert ref_np.shape == (NZ + 1, NY, NX) and ref_np.max() > 1.0


# ---- BMJ ------------------------------------------------------------------

def _convective(s, jgrid, temp, stab, n_moist_levels, warm):
    """In the first four columns of x the JAX package's BMJ test column (a
    neutral troposphere with a moist boundary layer ``n_moist_levels`` deep
    and its lowest two levels ``warm`` K warmer: deep convection); in the
    others a dry troposphere whose theta rises ``stab`` K/m (no CAPE)."""
    qs = np.asarray(jax_qsat(temp, np.asarray(jax_total_pressure(s, jgrid))))
    kk = np.arange(NZ).reshape(-1, 1, 1)
    z = np.asarray(jgrid.z_half).reshape(-1, 1, 1)
    deep = np.arange(NX).reshape(1, 1, -1) < 4
    qv = np.where(deep, np.where(kk < n_moist_levels, 0.95 * qs, 0.1 * qs), 0.0)
    thp = s.theta_p + np.where(deep, np.where(kk < 2, warm, 0.0), stab * z)
    return dataclasses.replace(s, theta_p=thp.astype(np.float32),
                               moist=np.concatenate([qv[None].astype(np.float32),
                                                     s.moist[1:]]))


BMJ_COLUMNS = (0.004, 3, 4.0)    # stab [K/m], moist levels, warm [K]


def test_bmj_step(setup):
    jgrid, grid, s, temp = setup
    sc = _convective(s, jgrid, temp, *BMJ_COLUMNS)
    # the gates, from the reference's intermediates: CAPE and depth well past
    # CAPE_MIN and MIN_DEPTH where deep, far below where not; no level at
    # the cloud edge (buoy -0.02), and none at zero buoyancy above the
    # parcel's own level (exactly 0 there in both packages); the rain
    # clearly > 0 where deep
    js = jax.tree.map(jnp.asarray, sc)
    tj = np.asarray(jax_temperature(js, jgrid))
    pj = np.asarray(jax_total_pressure(js, jgrid))
    tp = np.asarray(jax.jit(jcumulus._parcel_profile)(tj, sc.moist[0], pj))
    buoy = (tp - tj) / tj
    dz = (np.diff(np.asarray(jgrid.phb), axis=0) + np.diff(sc.ph, axis=0)) / jc.GRAV
    cape = (np.maximum(buoy, 0.0) * jc.GRAV * dz).sum(0)
    z = np.cumsum(dz, axis=0) - 0.5 * dz
    top = np.where(buoy > 0.0, z, 0.0).max(0)
    deep = np.arange(NX) < 4
    assert (cape[:, deep] > 3 * jcumulus.CAPE_MIN).all()
    assert (top[:, deep] > jcumulus.MIN_DEPTH + 1000.0).all()
    assert ((cape[:, ~deep] < 0.5 * jcumulus.CAPE_MIN)
            | (top[:, ~deep] < jcumulus.MIN_DEPTH - 1000.0)).all()
    assert np.abs(buoy + 0.02).min() > 1e-4 and np.abs(buoy[1:]).min() > 1e-4

    ref, rain_ref = jax.tree.map(np.asarray, jax.jit(
        lambda st: jcumulus.bmj_step(st, jgrid, 30.0))(sc))
    out, rain = cumulus.bmj_step(from_numpy(sc), grid, 30.0)
    out = to_numpy(out)
    assert (rain_ref[:, deep] > 1e-5).all() and (rain_ref[:, ~deep] == 0).all()
    close(rain, rain_ref)
    close(out.theta_p, ref.theta_p)
    close(out.moist, ref.moist)
    close(cumulus._parcel_profile(T(tj), T(sc.moist[0]), T(pj)), tp)


# ---- Kessler and WSM5 ------------------------------------------------------

def test_rain_fall_speed():
    r = np.random.default_rng(6)
    qr = (1e-3 * r.random((NZ, NY, NX))).astype(np.float32)
    rho = r.uniform(0.3, 1.2, (NZ, 1, 1)).astype(np.float32)
    close(microphysics.rain_fall_speed(T(qr), T(rho)),
          jax.jit(jmicro.rain_fall_speed)(qr, rho), rtol=1e-5, floor=0.0)


def _jit_and_eager(fn, s):
    ref = jax.tree.map(np.asarray, jax.jit(fn)(s))
    eager = jax.tree.map(np.asarray, fn(jax.tree.map(jnp.asarray, s)))
    return ref, eager


def _gates_clear(temp):
    """Both sides of 0 C (and of the homogeneous-freezing level) are
    present, and no cell sits within 0.05 K of either."""
    for t_gate in (jc.T_FREEZE, jc.T_HOMOG):
        assert (temp < t_gate).any() and (temp > t_gate).any()
        assert np.abs(temp - t_gate).min() > 0.05


def test_kessler_step(setup):
    jgrid, grid, s, temp = setup
    s3 = dataclasses.replace(s, moist=s.moist[:3])
    assert (s3.moist[0] > jax_qsat(temp, jax_total_pressure(s3, jgrid))).any()
    ref, eager = _jit_and_eager(lambda st: jmicro.kessler_step(st, jgrid, 30.0), s3)
    out = to_numpy(microphysics.kessler_step(from_numpy(s3), grid, 30.0))
    close(eager.theta_p, ref.theta_p)         # the reference's own spread is inside
    close(out.theta_p, ref.theta_p)
    for i in range(3):
        close(eager.moist[i], ref.moist[i], err_msg=f"eager moist[{i}]")
        close(out.moist[i], ref.moist[i], err_msg=f"moist[{i}]")
    moved = np.abs(ref.moist - s3.moist).max(axis=(1, 2, 3))
    assert (moved > 1e-6).all(), moved                  # every species evolved


def test_wsm5_step(setup):
    jgrid, grid, s, temp = setup
    _gates_clear(temp)
    ref, eager = _jit_and_eager(lambda st: jmicro.wsm5_step(st, jgrid, 30.0), s)
    out = to_numpy(microphysics.wsm5_step(from_numpy(s), grid, 30.0))
    close(eager.theta_p, ref.theta_p)
    close(out.theta_p, ref.theta_p)
    for i in range(5):
        close(eager.moist[i], ref.moist[i], err_msg=f"eager moist[{i}]")
        close(out.moist[i], ref.moist[i], err_msg=f"moist[{i}]")
    moved = np.abs(ref.moist - s.moist).max(axis=(1, 2, 3))
    assert (moved > 1e-6).all(), moved


def test_sat_mixing_ratio_ice(setup):
    jgrid, _, s, temp = setup
    pres = np.asarray(jax_total_pressure(s, jgrid))
    close(microphysics.sat_mixing_ratio_ice(T(temp), T(pres)),
          jax.jit(jmicro.sat_mixing_ratio_ice)(temp, pres), rtol=1e-5, floor=0.0)


# ---- single-column forcing --------------------------------------------------

@pytest.mark.parametrize("w_sub", [0.0, -0.01])
def test_scm_forcing(setup, w_sub):
    jgrid, grid, s, _ = setup
    jf = jscm.make_scm_forcing(jgrid, u=6.0, v=-1.0, theta_p=0.5, qv=0.008, tau=1800.0,
                               w_subsidence=w_sub)
    f = scm_forcing.make_scm_forcing(grid, u=6.0, v=-1.0, theta_p=0.5, qv=0.008,
                                     tau=1800.0, w_subsidence=w_sub)
    assert (f.tau, f.w_subsidence) == (jf.tau, jf.w_subsidence)
    np.testing.assert_array_equal(f.u_target.numpy(), np.asarray(jf.u_target))
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda st: jscm.apply_scm_forcing(st, jf, jgrid, 30.0))(s))
    out = to_numpy(scm_forcing.apply_scm_forcing(from_numpy(s), f, grid, 30.0))
    for name in ("u", "v", "theta_p", "moist"):
        close(getattr(out, name), getattr(ref, name), rtol=1e-6, floor=1e-7, err_msg=name)
