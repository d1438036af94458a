"""The port's idealized-case initializers against the JAX package's
(``models/dycore/ideal.py``) at 8x8x3 cells: every field of every case,
on a flat grid and over the hill terrain.  Fields are built with the
reference's float32 operations in its order, so they agree bit for bit
except where ``exp`` rounds: XLA-CPU's and torch's ``exp`` differ in the
last ulp on some inputs, and a blob's amplitude times an exp one ulp
apart can round 2 ulp apart, so every field is held to 2 ulp (the hill
terrain, numpy in both, exactly)."""

import dataclasses

import jax
import numpy as np
import pytest

from wrf_partmc_tpu.config import DomainConfig, uniform_test_config
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.dycore import ideal as jax_ideal
from wrf_partmc_tpu_torch.convert import config_from_reference, to_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.dycore import ideal

CFG = uniform_test_config().replace(
    domain=DomainConfig(nx=8, ny=8, nz=3, dx=2000.0, dy=2000.0, ztop=2000.0))

CASES = {
    "uniform": lambda m, cfg, g: m.init_uniform(cfg, g, 5.0, 2.0),
    "rotational": lambda m, cfg, g: m.init_rotational(cfg, g),
    "rotational_period": lambda m, cfg, g: m.init_rotational(cfg, g, period_s=700.0,
                                                             blob_conc=3e8),
    "warm_bubble": lambda m, cfg, g: m.init_warm_bubble(cfg, g),
    "scm": lambda m, cfg, g: m.init_scm(cfg, g),
    "arw_rest": lambda m, cfg, g: m.arw_rest_state(cfg, g),
    "warm_bubble_arw": lambda m, cfg, g: m.init_warm_bubble_arw(cfg, g, z_center=800.0,
                                                                z_radius=500.0),
    "density_current_arw": lambda m, cfg, g: m.init_density_current_arw(cfg, g),
}


def _both(case, hgt=None):
    jgrid = jax_make_grid(CFG, hgt=hgt)
    pcfg = config_from_reference(CFG)
    pgrid = make_grid(pcfg, hgt=hgt)
    ref = jax.tree.map(np.asarray, CASES[case](jax_ideal, CFG, jgrid))
    return ref, to_numpy(CASES[case](ideal, pcfg, pgrid))


@pytest.mark.parametrize("case", sorted(CASES))
def test_initializer_matches_jax(case):
    ref, out = _both(case)
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        if b is None:
            assert a is None, f.name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_max_ulp(a, b, maxulp=2)


@pytest.mark.parametrize("ridge", [False, True])
def test_hill_terrain_and_bubble_over_it(ridge):
    h = ideal.hill_terrain(config_from_reference(CFG), h0=300.0, ridge=ridge)
    np.testing.assert_array_equal(h, jax_ideal.hill_terrain(CFG, h0=300.0, ridge=ridge))
    ref, out = _both("warm_bubble_arw", hgt=h)
    np.testing.assert_array_max_ulp(out.theta_p, ref.theta_p, maxulp=2)
    assert float(np.abs(out.theta_p).max()) > 0.1
