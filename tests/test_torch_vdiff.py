"""Vertical diffusion: the port's ``vertical_diffusion_state`` (all six
fields through ``tridiag.solve_fields``) against the JAX package's, from
the same numpy inputs, at 12x12x4 with moist L = 3 and chem L = 32.

Both sides build the coefficients with the same float32 formulas and run
the same Thomas recurrence; torch and XLA-CPU may round the coefficient
divisions differently in the last ulp, so the fields are held at rtol 1e-6
with an absolute floor of 1e-6 of each field's scale.  The fields vdiff
does not touch come back unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.config import DomainConfig, uniform_test_config
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.dycore.ideal import init_uniform as jax_init_uniform
from wrf_partmc_tpu.models.dycore.state import base_profiles as jax_base_profiles
from wrf_partmc_tpu.ops.vdiff import vertical_diffusion_state as jax_vdiff
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.dycore.state import base_profiles
from wrf_partmc_tpu_torch.ops import tridiag
from wrf_partmc_tpu_torch.ops.vdiff import FIELDS, vertical_diffusion_state

DT = 60.0


@pytest.fixture(scope="module")
def diffused():
    cfg = uniform_test_config().replace(
        domain=DomainConfig(nx=12, ny=12, nz=4, dx=2000.0, dy=2000.0, ztop=2000.0),
        n_class=8)
    jgrid = jax_make_grid(cfg)
    s = jax.tree.map(np.asarray, jax_init_uniform(cfg, jgrid, 5.0, 2.0))
    r = np.random.default_rng(7)
    f32 = lambda a: np.asarray(a, np.float32)
    shape3 = s.theta_p.shape
    s = dataclasses.replace(
        s,
        u=f32(s.u + r.normal(0.0, 2.0, s.u.shape)),
        v=f32(s.v + r.normal(0.0, 2.0, s.v.shape)),
        theta_p=f32(r.normal(0.0, 1.5, shape3)),
        moist=f32(np.abs(r.normal(0.0, 1e-3, (3, *shape3)))),
        chem=f32(r.uniform(0.0, 0.05, (32, *shape3))),
        tke=f32(r.uniform(0.0, 1.0, shape3)))
    kv = f32(r.uniform(1.0, 80.0, (shape3[0] + 1, *shape3[1:])))
    jrho = jax_base_profiles(jgrid)[0]
    ref = jax.tree.map(np.asarray, jax_vdiff(jax.tree.map(jnp.asarray, s), jnp.asarray(kv),
                                             jgrid, jrho, DT))
    grid = make_grid(config_from_reference(cfg))
    before = tridiag.thomas_solve.launches
    out = vertical_diffusion_state(from_numpy(s), torch.from_numpy(kv), grid,
                                   base_profiles(grid)[0], DT)
    assert tridiag.thomas_solve.launches == before     # the CPU takes the plain path
    return s, ref, to_numpy(out)


@pytest.mark.parametrize("name", FIELDS)
def test_vdiff_fields_match_jax(diffused, name):
    s, ref, out = diffused
    a, b = getattr(out, name), getattr(ref, name)
    assert a.shape == b.shape == getattr(s, name).shape and a.dtype == np.float32
    assert np.abs(a - getattr(s, name)).max() > 0.0          # the solve changed it
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * float(np.abs(b).max()))


def test_vdiff_leaves_other_fields(diffused):
    s, _, out = diffused
    for name in ("w", "p_p", "mu", "ph", "num_conc"):
        np.testing.assert_array_equal(getattr(out, name), getattr(s, name))


@pytest.mark.parametrize("L", [1, 3, 32])
def test_solve_fields_plain_is_solve_scan_per_field(L):
    """A stacked field [L, n, *cols] gives, bit for bit, what solve_scan
    gives each of its L slices."""
    r = np.random.default_rng(L)
    n, cols = 10, (5, 6)
    dl, du = (torch.from_numpy(r.standard_normal((n, *cols)).astype(np.float32))
              for _ in range(2))
    d = torch.from_numpy((4.0 + np.abs(r.standard_normal((n, *cols)))).astype(np.float32))
    f = torch.from_numpy(r.standard_normal((L, n, *cols)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((n, *cols)).astype(np.float32))
    x, y = tridiag.solve_fields(dl, d, du, [f, g])
    assert x.shape == f.shape and y.shape == g.shape
    for i in range(L):
        assert torch.equal(x[i], tridiag.solve_scan(dl, d, du, f[i]))
    assert torch.equal(y, tridiag.solve_scan(dl, d, du, g))
