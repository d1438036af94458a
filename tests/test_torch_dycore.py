"""One ARW ``solve_step`` of the port against the JAX package at 12x12x4.

The state is the em_uniform initial state (live dynamics) with a warm
bubble, moisture and number-tracer perturbations made with numpy, so every
term of the core (buoyancy, acoustic W'' solve through K1, PD and monotonic
scalar advection with flux capture) is exercised.  The number tracers sit
on a positive background, as the particles give them in the coupled step:
the captured probabilities divide by the tracer and are ill-conditioned
where it underflows.  The two frameworks round
transcendentals (exp, log, pow) differently in the last ulp; over one step
those differences stay at the 1e-5 relative level, so fields are held at
rtol 1e-4 with an absolute floor of 1e-4 of each field's scale.
"""

import dataclasses

import jax
import numpy as np
import pytest

from wrf_partmc_tpu.config import DomainConfig, uniform_test_config
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.dycore.ideal import init_uniform as jax_init_uniform
from wrf_partmc_tpu.models.dycore.solve import solve_step as jax_solve_step
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.dycore.solve import solve_step


@pytest.fixture(scope="module")
def stepped():
    cfg = uniform_test_config().replace(
        domain=DomainConfig(nx=12, ny=12, nz=4, dx=2000.0, dy=2000.0, ztop=2000.0),
        n_class=8)
    cfg = cfg.replace(dynamics=dataclasses.replace(cfg.dynamics,
                                                   constant_velocity=False))
    jgrid = jax_make_grid(cfg)
    s = jax.tree.map(np.asarray, jax_init_uniform(cfg, jgrid, 5.0, 2.0))
    r = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    bubble = 1.5 * np.exp(-((xx - 6.0) ** 2 + (yy - 5.0) ** 2) / 8.0)
    s = dataclasses.replace(
        s,
        theta_p=(s.theta_p + bubble[None] * np.array([1.0, 0.6, 0.2, 0.0])[:, None, None]
                 ).astype(np.float32),
        moist=(s.moist + np.abs(r.normal(0, 1e-3, s.moist.shape))).astype(np.float32),
        num_conc=(s.num_conc + 1e8 * r.uniform(0.5, 1.5, s.num_conc.shape)
                  ).astype(np.float32),
        chem=r.uniform(0.0, 0.05, s.chem.shape).astype(np.float32))
    jnew, jdiag = jax.jit(lambda st: jax_solve_step(st, jgrid, cfg))(s)
    jnew, jdiag = jax.tree.map(np.asarray, (jnew, jdiag))
    pcfg = config_from_reference(cfg)
    new, diag = solve_step(from_numpy(s), make_grid(pcfg), pcfg)
    return jnew, jdiag, to_numpy(new), to_numpy(diag)


FIELDS = ["u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem", "num_conc", "tke"]


@pytest.mark.parametrize("name", FIELDS)
def test_solve_step_fields(stepped, name):
    jnew, _, new, _ = stepped
    ref, out = getattr(jnew, name), getattr(new, name)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    scale = float(np.abs(ref).max()) + 1e-30
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("face", ["xm", "xp", "ym", "yp", "zm", "zp"])
def test_solve_step_outflow_probs(stepped, face):
    _, jdiag, _, diag = stepped
    np.testing.assert_allclose(getattr(diag.probs, face), getattr(jdiag.probs, face),
                               rtol=1e-4, atol=1e-6)


def test_solve_step_mass_fluxes(stepped):
    _, jdiag, _, diag = stepped
    for name in ("rho_u", "rho_v", "rho_w", "xkhh"):
        ref = getattr(jdiag, name)
        np.testing.assert_allclose(getattr(diag, name), ref, rtol=1e-4,
                                   atol=1e-4 * (np.abs(ref).max() + 1e-30))
