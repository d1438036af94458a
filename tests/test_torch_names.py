"""The port's twins of the JAX package's remaining public helpers, each
against the JAX function on the same numpy inputs made from a seed:
``ops.stencil.avg_to_faces``/``diff_at_faces`` (exact: one add and one
multiply), ``ops.vdiff.diffuse_column`` (rtol 1e-6 with a floor of 1e-6 of
the field's scale, as tests/test_torch_vdiff.py: torch and XLA-CPU may
round the Thomas divisions differently in the last ulp),
``models.dycore.state.air_density`` (rtol 1e-6),
``models.partmc.aero_data.parse_aero_data_dat``,
``models.partmc.gas_data.parse_gas_data_dat``/``zero_gas_state``,
``utils.rng.name_seed`` and ``models.partmc.env_state.make_env_state``
(exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.config import DomainConfig, uniform_test_config
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.dycore import state as jstate
from wrf_partmc_tpu.models.dycore.ideal import init_uniform as jax_init_uniform
from wrf_partmc_tpu.models.partmc import aero_data as jaero_data
from wrf_partmc_tpu.models.partmc import env_state as jenv_state
from wrf_partmc_tpu.models.partmc import gas_data as jgas_data
from wrf_partmc_tpu.ops import stencil as jstencil
from wrf_partmc_tpu.ops import vdiff as jvdiff
from wrf_partmc_tpu.utils import rng as jrng
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.dycore import state
from wrf_partmc_tpu_torch.models.partmc import aero_data, env_state, gas_data
from wrf_partmc_tpu_torch.ops import stencil, vdiff
from wrf_partmc_tpu_torch.utils import rng

SHAPE = (4, 6, 7)


def _field(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("fn", ["avg_to_faces", "diff_at_faces"])
@pytest.mark.parametrize("axis", [-3, -2, -1])
@pytest.mark.parametrize("bc", ["periodic", "clamp"])
def test_face_helpers(fn, axis, bc):
    a = _field()
    ref = np.asarray(getattr(jstencil, fn)(jnp.asarray(a), axis, bc))
    np.testing.assert_array_equal(getattr(stencil, fn)(torch.tensor(a), axis, bc).numpy(), ref)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_diffuse_column(lead):
    r = np.random.default_rng(3)
    dl = -r.uniform(0.0, 0.4, SHAPE).astype(np.float32)
    du = -r.uniform(0.0, 0.4, SHAPE).astype(np.float32)
    d = (1.0 - dl - du).astype(np.float32)
    f = _field(4, (*lead, *SHAPE))
    ref = np.asarray(jvdiff.diffuse_column(*(jnp.asarray(x) for x in (f, dl, d, du))))
    out = vdiff.diffuse_column(*(torch.tensor(x) for x in (f, dl, d, du))).numpy()
    assert out.shape == ref.shape == f.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_air_density():
    cfg = uniform_test_config().replace(
        domain=DomainConfig(nx=7, ny=6, nz=4, dx=2000.0, dy=2000.0, ztop=2000.0), n_class=8)
    jgrid = jax_make_grid(cfg)
    s = jax.tree.map(np.asarray, jax_init_uniform(cfg, jgrid, 5.0, 2.0))
    r = np.random.default_rng(5)
    s = dataclasses.replace(s, theta_p=r.normal(0.0, 2.0, s.theta_p.shape).astype(np.float32),
                            p_p=r.normal(0.0, 200.0, s.p_p.shape).astype(np.float32))
    ref = np.asarray(jstate.air_density(jax.tree.map(jnp.asarray, s), jgrid))
    out = state.air_density(from_numpy(s), make_grid(config_from_reference(cfg))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


AERO_DAT = """# name  density  num_ions  molec_weight  kappa
SO4   1800  0  96e-3   0.65   # sulfate
NH4   1800  0  18e-3   0.65

OC    1000  0  1e-3    0.001
H2O   1000  0  18e-3   0
"""
GAS_DAT = """# name molec_weight
H2SO4 98e-3
NH3 17e-3   # ammonia
DMS
"""


def test_parse_aero_data_dat():
    ref, out = jaero_data.parse_aero_data_dat(AERO_DAT), aero_data.parse_aero_data_dat(AERO_DAT)
    assert out.names == ref.names == ("SO4", "NH4", "OC", "H2O")
    for f in ("density", "num_ions", "molec_weight", "kappa"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
    with pytest.raises(ValueError, match="no species rows"):
        aero_data.parse_aero_data_dat("# nothing\n")


def test_parse_gas_data_dat_and_zero_state():
    ref, out = jgas_data.parse_gas_data_dat(GAS_DAT), gas_data.parse_gas_data_dat(GAS_DAT)
    assert out.names == ref.names == ("H2SO4", "NH3", "DMS")
    np.testing.assert_array_equal(out.molec_weight.numpy(), np.asarray(ref.molec_weight))
    z_ref = np.asarray(jgas_data.zero_gas_state(ref, (2, 3, 4)))
    z = gas_data.zero_gas_state(out, (2, 3, 4))
    assert z.dtype == torch.float32 and z.shape == z_ref.shape == (2, 3, 4, 3)
    np.testing.assert_array_equal(z.numpy(), z_ref)


@pytest.mark.parametrize("name", ["", "ensemble-member-07", "urban_plume", "ß-ünïcode"])
def test_name_seed(name):
    assert rng.name_seed(name) == jrng.name_seed(name)
    assert 0 <= rng.name_seed(name) < 2 ** 31


@pytest.mark.parametrize("cell_shape", [(), (2, 3, 4)])
@pytest.mark.parametrize("kw", [{}, dict(rel_humid=0.0), dict(rel_humid=1.0),
                                dict(temp=250.5, pressure=7.3e4, rel_humid=0.31, height=812.5,
                                     cell_volume=8.0e9, ustar=0.05, elapsed_time=1234.1)],
                         ids=["default", "rh0", "rh1", "custom"])
def test_make_env_state(cell_shape, kw):
    """Every field exact, float32, over the cell shape; rel_humid 0 and 1 are
    clipped to 0.001 and 0.95.  The JAX EnvState fills elapsed_time as an
    array; the port's holds a float (the coupled step's EnvState does)."""
    ref = jenv_state.make_env_state(cell_shape=cell_shape, **kw)
    out = env_state.make_env_state(cell_shape=cell_shape, device="cpu", **kw)
    for f in ("temp", "pressure", "rel_humid", "height", "cell_volume", "ustar"):
        a = getattr(out, f)
        assert a.dtype == torch.float32 and tuple(a.shape) == cell_shape, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    ref_t = np.asarray(ref.elapsed_time)
    assert ref_t.shape == cell_shape and isinstance(out.elapsed_time, float)
    assert (ref_t == out.elapsed_time).all()
    if "rel_humid" in kw and kw["rel_humid"] in (0.0, 1.0):
        assert float(out.rel_humid.flatten()[0]) == float(np.float32(
            0.001 if kw["rel_humid"] == 0.0 else 0.95))
