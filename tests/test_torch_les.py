"""The port's LES options against the JAX package: the moist-free N^2, the
prognostic-TKE closure (coefficients and one advance, with the advective
tendency it uses), the NBA1 subfilter stresses, the WENO5/WENO3 face
values and fluxes on periodic and clamped axes, the RK3 limited updates
with WENO orders (the advected field and the captured outflow
probabilities), and one ARW ``solve_step`` with the whole LES option set
(km_opt=2 with diff_opt=2, sfs_opt=1, WENO5/WENO3, Kessler).

Inputs are ``tests/test_les.py``'s configuration at 10x9x8 (dx 50 m, ztop
800 m, dt 0.25 s): its warm bubble and near-surface noise, with random
winds, TKE and moisture made with numpy.  Stencils without transcendentals
(N^2, the stresses, WENO) are held at rtol 1e-5 with a floor of 1e-6 of
each field's scale; the TKE closure (sqrt, e^1.5) at rtol 1e-5 too; the
RK3 updates and the dycore step at rtol 1e-4 with a floor of 1e-4 of the
scale, as ``tests/test_torch_dycore.py`` holds the default options, but for
the step's xkhh (5e-3, see ``test_les_solve_step_diag``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.config import Config, DomainConfig, DynamicsConfig
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.dycore import solve as jsolve
from wrf_partmc_tpu.models.dycore.ideal import init_warm_bubble_arw
from wrf_partmc_tpu.models.physics import sfs_nba as jnba
from wrf_partmc_tpu.ops import advection as jadv

from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.dycore import solve
from wrf_partmc_tpu_torch.models.physics import sfs_nba
from wrf_partmc_tpu_torch.ops import advection
from wrf_partmc_tpu_torch.ops.stencil import AXIS_X, AXIS_Y, AXIS_Z

NZ, NY, NX = 8, 9, 10


def close(out, ref, rtol=1e-5, floor=1e-6, err_msg=""):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=floor * (float(np.abs(ref).max()) + 1e-30),
                               err_msg=err_msg)


def T(a):
    return torch.tensor(np.asarray(a))


def les_cfg():
    return Config(domain=DomainConfig(nx=NX, ny=NY, nz=NZ, dx=50.0, dy=50.0, ztop=800.0),
                  dynamics=DynamicsConfig(dt=0.25, n_sound=4, dyn_opt="arw", damp_opt=1,
                                          zdamp=200.0, sfs_opt=1, diff_opt=2, km_opt=2,
                                          h_adv_order="weno5", v_adv_order="weno3",
                                          mp_physics=1))


@pytest.fixture(scope="module")
def les():
    cfg = les_cfg()
    jgrid = jax_make_grid(cfg)
    s = init_warm_bubble_arw(cfg, jgrid, d_theta=1.0, z_center=150.0, z_radius=120.0)
    kk = jax.random.normal(jax.random.key(0), (2, NY, NX)) * 0.2
    s = jax.tree.map(np.asarray, dataclasses.replace(s, theta_p=s.theta_p.at[:2].add(kk)))
    r = np.random.default_rng(0)
    s = dataclasses.replace(
        s,
        u=r.normal(2.0, 1.0, s.u.shape).astype(np.float32),
        v=r.normal(-1.0, 1.0, s.v.shape).astype(np.float32),
        w=(r.normal(0.0, 0.3, s.w.shape) * (np.arange(NZ + 1) % NZ != 0)[:, None, None]
           ).astype(np.float32),
        tke=r.uniform(0.01, 0.5, s.tke.shape).astype(np.float32),
        moist=np.abs(r.normal(0.0, 2e-3, s.moist.shape)).astype(np.float32))
    pcfg = config_from_reference(cfg)
    return cfg, jgrid, pcfg, make_grid(pcfg), s


# ---- the TKE closure ---------------------------------------------------------

def test_brunt_vaisala_sq(les):
    cfg, jgrid, pcfg, grid, s = les
    ref = jax.jit(lambda st: jsolve.brunt_vaisala_sq(st, jgrid))(s)
    out = solve.brunt_vaisala_sq(from_numpy(s), grid)
    close(out, ref)
    ref = np.asarray(ref)
    assert (ref > 1e-10).any() and (ref < 1e-10).any()        # both length branches


def test_tke_eddy_coeffs(les):
    cfg, jgrid, pcfg, grid, s = les
    ref = jax.jit(lambda st: jsolve.tke_eddy_coeffs(st, jgrid, cfg))(s)
    out = solve.tke_eddy_coeffs(from_numpy(s), grid, pcfg)
    for name, o, rr in zip(("km", "kh", "length", "delta"), out, ref):
        close(o, rr, err_msg=name)


def test_advective_tendency(les):
    """The linear-core helper tke_advance uses: -v.grad(e) at orders 2/2."""
    cfg, jgrid, pcfg, grid, s = les
    rho_b = np.asarray(jsolve.base_profiles(jgrid)[0])
    rho_c = rho_b.reshape(-1, 1, 1)
    rho_f = np.asarray(jsolve._rho_faces(rho_b)).reshape(-1, 1, 1)
    close(solve._rho_faces(T(rho_b)), jsolve._rho_faces(rho_b), rtol=0.0, floor=0.0)
    args = (s.tke, rho_c * s.u, rho_c * s.v, rho_f * s.w, rho_c, jgrid.rdx, jgrid.rdy,
            1.0 / np.asarray(jgrid.dz))
    ref = jax.jit(lambda *a: jsolve._advective_tendency(*a, 2, 2, "periodic", "periodic"))(
        *args)
    out = solve._advective_tendency(*(T(a) if isinstance(a, np.ndarray) else a for a in args),
                                    2, 2, "periodic", "periodic")
    close(out, ref)


def test_tke_advance(les):
    cfg, jgrid, pcfg, grid, s = les
    e_ref, kh_ref = jax.jit(lambda st: jsolve.tke_advance(st, jgrid, cfg, 0.25))(s)
    e_out, kh_out = solve.tke_advance(from_numpy(s), grid, pcfg, 0.25)
    close(e_out, e_ref)
    close(kh_out, kh_ref)
    assert np.abs(np.asarray(e_ref) - s.tke).max() > 1e-3       # the TKE moved


def test_horizontal_k_tke(les):
    """The slow-variable mixing's K with km_opt=2 is the closure's K_h."""
    cfg, jgrid, pcfg, grid, s = les
    _, kh_ref, _, _ = jax.jit(lambda st: jsolve.tke_eddy_coeffs(st, jgrid, cfg))(s)
    close(solve.horizontal_k(from_numpy(s), grid, pcfg), kh_ref)


# ---- NBA ---------------------------------------------------------------------

@pytest.mark.parametrize("bx,by", [("periodic", "periodic"), ("clamp", "periodic"),
                                   ("periodic", "clamp")])
def test_nba_stress_tendencies(les, bx, by):
    cfg, jgrid, pcfg, grid, s = les
    r = np.random.default_rng(1)
    u_c, v_c, w_c = (r.normal(0.0, 2.0, (NZ, NY, NX)).astype(np.float32) for _ in range(3))
    ref = jax.jit(lambda *a: jnba.nba_stress_tendencies(*a, jgrid, bx, by,
                                                        return_stress=True))(u_c, v_c, w_c)
    out = sfs_nba.nba_stress_tendencies(T(u_c), T(v_c), T(w_c), grid, bx, by,
                                        return_stress=True)
    for o, rr in zip(out[0] + out[1], ref[0] + ref[1]):
        close(o, rr)
    du = sfs_nba.nba_stress_tendencies(T(u_c), T(v_c), T(w_c), grid, bx, by)
    for o, rr in zip(du, ref[0]):
        close(o, rr)


# ---- WENO --------------------------------------------------------------------

def _tracer(seed, scale):
    """A smooth field with a sharp front and a zero patch, times ``scale``
    (1e9 is a number concentration's size)."""
    r = np.random.default_rng(seed)
    q = 1.0 + 0.5 * np.sin(np.arange(NX) / 2.0)[None, None, :] + 0.2 * r.random((NZ, NY, NX))
    q[:, 3:6, 4:7] = 3.0
    q[:2, :2, :2] = 0.0
    return (scale * q).astype(np.float32)


@pytest.mark.parametrize("order", [5, 3])
@pytest.mark.parametrize("axis,bc", [(AXIS_X, "periodic"), (AXIS_Y, "clamp"),
                                     (AXIS_Z, "clamp")])
@pytest.mark.parametrize("scale", [1.0, 1e9])
def test_weno_face_value(order, axis, bc, scale):
    q = _tracer(2, scale)
    vel = np.random.default_rng(3).normal(0.0, 1.0, q.shape).astype(np.float32)
    ref = jax.jit(lambda a, b: jadv._weno_face_value(a, b >= 0.0, order, axis, bc))(q, vel)
    out = advection._weno_face_value(T(q), T(vel) >= 0.0, order, axis, bc)
    close(out, ref)
    assert (vel > 0).any() and (vel < 0).any()


@pytest.mark.parametrize("ho,vo", [("weno5", "weno3"), ("weno3", "weno5"), ("weno5", 3)])
def test_face_fluxes_weno(les, ho, vo):
    """Both horizontal orders; a vertical WENO order always runs as weno3."""
    cfg, jgrid, pcfg, grid, s = les
    q = _tracer(4, 1e9)[None].repeat(2, axis=0)
    r = np.random.default_rng(5)
    ru, rv = (r.normal(0.0, 1.0, (NZ, NY, NX)).astype(np.float32) for _ in range(2))
    rw = r.normal(0.0, 0.3, (NZ + 1, NY, NX)).astype(np.float32)
    ref = jax.jit(lambda *a: jadv.face_fluxes(*a, ho, vo, "periodic", "clamp"))(q, ru, rv, rw)
    out = advection.face_fluxes(T(q), T(ru), T(rv), T(rw), ho, vo, "periodic", "clamp")
    for o, rr in zip(out, ref):
        close(o, rr)


@pytest.mark.parametrize("limiter", ["pd", "mono"])
def test_rk3_advect_weno(les, limiter):
    """The advected field and the outflow probabilities the particle
    transport reads, both captured from WENO fluxes."""
    cfg, jgrid, pcfg, grid, s = les
    q = np.stack([_tracer(6, 1e9), _tracer(7, 1.0)])
    r = np.random.default_rng(8)
    ru, rv = (r.normal(0.0, 1.0, (NZ, NY, NX)).astype(np.float32) for _ in range(2))
    rw = (r.normal(0.0, 0.3, (NZ + 1, NY, NX))
          * (np.arange(NZ + 1) % NZ != 0)[:, None, None]).astype(np.float32)
    rho = np.asarray(jsolve.base_profiles(jgrid)[0])
    rdz = 1.0 / np.asarray(jgrid.dz)
    jfn = jadv.rk3_advect_pd if limiter == "pd" else jadv.rk3_advect_mono
    fn = advection.rk3_advect_pd if limiter == "pd" else advection.rk3_advect_mono
    ref_q, ref_p = jax.jit(lambda *a: jfn(*a, 0.25, jgrid.rdx, jgrid.rdy, rdz, "weno5",
                                          "weno3", "periodic", "clamp"))(q, ru, rv, rw, rho)
    out_q, out_p = fn(T(q), T(ru), T(rv), T(rw), T(rho), 0.25, grid.rdx, grid.rdy, T(rdz),
                      "weno5", "weno3", "periodic", "clamp")
    close(out_q, ref_q, rtol=1e-4, floor=1e-4)
    for face in ("xm", "xp", "ym", "yp", "zm", "zp"):
        close(getattr(out_p, face), getattr(ref_p, face), rtol=1e-4, floor=1e-4,
              err_msg=face)
    assert float(np.asarray(ref_p.xp).max()) > 1e-3


# ---- one dycore step with the LES options -------------------------------------

@pytest.fixture(scope="module")
def stepped(les):
    cfg, jgrid, pcfg, grid, s = les
    jnew, jdiag = jax.tree.map(np.asarray, jax.jit(
        lambda st: jsolve.solve_step(st, jgrid, cfg))(s))
    new, diag = solve.solve_step(from_numpy(s), grid, pcfg)
    return jnew, jdiag, to_numpy(new), to_numpy(diag), s


@pytest.mark.parametrize("name", ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist",
                                  "chem", "num_conc", "tke"])
def test_les_solve_step_fields(stepped, name):
    jnew, _, new, _, _ = stepped
    close(getattr(new, name), getattr(jnew, name), rtol=1e-4, floor=1e-4)


def test_les_solve_step_diag(stepped):
    jnew, jdiag, new, diag, s = stepped
    for face in ("xm", "xp", "ym", "yp", "zm", "zp"):
        close(getattr(diag.probs, face), getattr(jdiag.probs, face), rtol=1e-4, floor=1e-4,
              err_msg=face)
    # xkhh is the closure's K_h of the new state, whose mixing length takes
    # N^2 from theta differences between levels (0.01-0.1 K on ~300 K): the
    # 1e-6 relative rounding of theta moves it by up to 2e-3 relative where
    # the stratification is weak, so it is held at 5e-3
    close(diag.xkhh, jdiag.xkhh, rtol=5e-3, floor=1e-4)
    assert np.abs(jnew.tke - s.tke).max() > 1e-3          # TKE advanced in the step
