"""The port's sea-salt source against the JAX package: the Gong (2003) flux
spectrum, the binned number fluxes (``seasalt_param`` 1 and 2), the
fixed-slot sample, the universe with its two sea-salt classes, and the
coupled step's emission with the sea-salt branch.

The fluxes chain float32 powers and exponentials that XLA-CPU and torch
round differently in the last ulp: held at rtol 1e-5.  The sample's bins
come from ``rng.categorical`` over the log fluxes, the draw
``jax.random.categorical`` makes; at these sizes (480 draws) no bin
flips: the sampled volumes, which differ by a factor of about 5 from one
bin to the next, are held at rtol 1e-6 (the last ulp of the float32 volume
arithmetic), which holds the drawn bins equal, and the per-entry numbers at
rtol 1e-5.  The emission
step is compared slot for slot: alive masks, sources and classes equal,
numbers and volumes at rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.config import DomainConfig, PartmcConfig, uniform_test_config
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.coupled import driver as jdriver
from wrf_partmc_tpu.models.coupled.init import populate_from_number_field
from wrf_partmc_tpu.models.dycore.ideal import init_uniform
from wrf_partmc_tpu.models.partmc import seasalt as jseasalt
from wrf_partmc_tpu.models.partmc import sources as jsources
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.dist import make_mode as jax_make_mode
from wrf_partmc_tpu.models.partmc.gas_data import make_gas_data as jax_make_gas_data
from wrf_partmc_tpu.models.partmc.scenario import constant_scenario

from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.coupled import driver
from wrf_partmc_tpu_torch.models.partmc import seasalt, sources
from wrf_partmc_tpu_torch.models.partmc.aero_data import make_aero_data
from wrf_partmc_tpu_torch.models.partmc.dist import make_mode


def kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def close(out, ref, rtol=1e-5, err_msg=""):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=rtol, atol=0.0, err_msg=err_msg)


def test_gong03_dFdr():
    r = np.geomspace(0.03, 8.0, 60).astype(np.float32)[:, None]
    u = np.array([[0.5, 3.0, 7.5, 12.0, 25.0]], np.float32)
    ref = jax.jit(jseasalt.gong03_dFdr)(r, u)
    close(seasalt.gong03_dFdr(torch.tensor(r), torch.tensor(u)), ref)
    assert np.all(np.asarray(ref) > 0)


@pytest.mark.parametrize("param", [1, 2])
def test_seasalt_number_fluxes(param):
    u10 = np.array([[2.0, 6.0, 9.0, 14.0], [0.3, 11.0, 20.0, 40.0]], np.float32)
    rc_ref, f_ref = jax.jit(lambda u: jseasalt.seasalt_number_fluxes(u, param=param))(u10)
    rc, f = seasalt.seasalt_number_fluxes(torch.tensor(u10), param=param)
    np.testing.assert_array_equal(rc.numpy(), np.asarray(rc_ref))
    close(f, f_ref)
    assert f.shape == (2, 4, 8)


@pytest.mark.parametrize("param,spume,split", [(1, None, 10.0), (2, None, 10.0),
                                               (1, 2, 1.0)])
def test_sample_seasalt(param, spume, split):
    """The same bins (volumes to the last ulp) and classes; with ``split``
    1 um both the film and the spume class are drawn."""
    jad, ad = jax_make_aero_data(), make_aero_data(device="cpu")
    cell_shape = (3, 4, 5)
    u10 = np.random.default_rng(param).uniform(2.0, 18.0, cell_shape).astype(np.float32)
    key = jax.random.fold_in(jax.random.key(11), param)
    kw = dict(param=param, source=4, w_class=1, w_class_spume=spume, r80_split_um=split)
    ref = jax.tree.map(np.asarray, jax.jit(lambda k, u: jseasalt.sample_seasalt(
        k, jad, u, 4.0e6, 10.0, 8, cell_shape, **kw))(key, u10))
    out = seasalt.sample_seasalt(kd(key), ad, torch.tensor(u10), 4.0e6, 10.0, 8,
                                 cell_shape, **kw)
    vol, num, src, wcl = (o.numpy() for o in out)
    assert vol.shape == ref[0].shape == (*cell_shape, ad.n_spec, 8)
    close(vol, ref[0], rtol=1e-6)                     # the drawn bins agree
    close(num, ref[1])
    np.testing.assert_array_equal(src, ref[2])
    np.testing.assert_array_equal(wcl, ref[3])
    i_na, i_cl = ad.spec_by_name("Na"), ad.spec_by_name("Cl")
    assert (vol[..., i_na, :] > 0).all()
    np.testing.assert_allclose(vol[..., i_cl, :], 1.5 * vol[..., i_na, :], rtol=1e-6)
    assert len(np.unique(vol[..., i_na, :])) > 3      # several bins drawn
    if spume is not None:
        assert set(np.unique(wcl)) == {1, 2}


def test_build_universe_seasalt():
    jad = jax_make_aero_data()
    vf = np.zeros(jad.n_spec)
    vf[0] = 1.0
    named = lambda mk: dict(
        ic=[("background", mk(1e9, 1e-7, 1.6, vf))],
        bc=[("inflow", mk(5e8, 1e-7, 1.6, vf))],
        emissions=[("traffic", mk(1e5, 5e-8, 1.8, vf)), ("industry", mk(2e4, 1e-7, 2.0, vf)),
                   ("biomass", mk(1e4, 8e-8, 1.7, vf))])
    juni, jic, jbc, jem = jsources.build_universe(**named(jax_make_mode), seasalt=True)
    uni, ic, bc, em = sources.build_universe(
        **named(lambda *a: make_mode(*a, device="cpu")), seasalt=True)
    assert (uni.sources, uni.classes, uni.source_class) == (
        juni.sources, juni.classes, juni.source_class)
    assert uni.n_source == 6 and uni.n_class == 7
    assert uni.source_id("seasalt") == juni.source_id("seasalt") == 5
    assert uni.classes[-2:] == ("seasalt", "seasalt_spume")
    assert sources.SEASALT_CLASSES == jsources.SEASALT_CLASSES
    for d, jd in zip(ic + bc + em, jic + jbc + jem):
        np.testing.assert_array_equal(d.source.numpy(), np.asarray(jd.source))
        np.testing.assert_array_equal(d.w_class.numpy(), np.asarray(jd.w_class))
    uni2, *_ = sources.build_universe(ic=[("bg", ic[0])], emissions=[("bg", em[0])])
    assert uni2.n_source == 1 and uni2.n_class == 1
    sources.validate_universe(uni, 8)
    with pytest.raises(ValueError):
        sources.validate_universe(uni, 4)


@pytest.fixture(scope="module")
def emission_inputs():
    cfg = uniform_test_config().replace(
        domain=DomainConfig(nx=8, ny=6, nz=3, dx=2000.0, dy=2000.0, ztop=2000.0),
        partmc=PartmcConfig(num_particles=8, max_particles=24, n_emit_slots=4,
                            seasalt_param=1, seasalt_class_film=1),
        n_class=3)
    cfg = cfg.replace(dynamics=dataclasses.replace(cfg.dynamics, constant_velocity=False))
    jgrid = jax_make_grid(cfg)
    jad, jgd = jax_make_aero_data(), jax_make_gas_data()
    dyn = init_uniform(cfg, jgrid, u0=12.0, v0=-4.0)
    # a wind that varies by column, so every cell gets its own fluxes
    r = np.random.default_rng(3)
    dyn = dataclasses.replace(dyn, u=dyn.u + jnp.asarray(r.normal(0, 3, dyn.u.shape),
                                                         jnp.float32))
    aero = populate_from_number_field(jad, cfg, jgrid, dyn.num_conc[0], jax.random.key(0))
    vf = np.zeros(jad.n_spec)
    vf[jad.spec_by_name("SO4")] = 1.0
    scn = constant_scenario(jad, jgd.n_spec, jax_make_mode(2e3, 5e-8, 1.6, vf))
    gas = jnp.zeros((3, 6, 8, jgd.n_spec), jnp.float32)
    env = jdriver.make_env(dyn, jgrid, cfg, 0)
    return cfg, jgrid, jad, dyn, aero, scn, gas, env


@pytest.mark.parametrize("do_emission", [True, False])
def test_emission_step_seasalt(emission_inputs, do_emission):
    """The sea-salt branch (alone, and after the scenario emission): Na+Cl
    particles in level 0 only, slot for slot as the reference places them."""
    cfg, jgrid, jad, dyn, aero, scn, gas, env = emission_inputs
    cfg = cfg.replace(partmc=dataclasses.replace(cfg.partmc, do_emission=do_emission))
    key = jax.random.key(5)
    t = 30.0
    ref_a, ref_g = jax.tree.map(np.asarray, jax.jit(
        lambda a, g: jdriver.emission_step(a, g, env, jad, scn, cfg, jgrid, dyn, t, key))(
        aero, gas))
    host = lambda x: from_numpy(jax.tree.map(np.asarray, x))
    pcfg = config_from_reference(cfg)
    out_a, out_g = driver.emission_step(host(aero), host(gas), host(env), host(jad),
                                        host(scn), pcfg, host(jgrid), host(dyn), t, kd(key))
    out_a = to_numpy(out_a)
    np.testing.assert_array_equal(out_a.num > 0, ref_a.num > 0)
    close(out_a.num, ref_a.num)
    close(out_a.vol, ref_a.vol)
    for name in ("source", "w_class", "pid", "next_id"):
        np.testing.assert_array_equal(getattr(out_a, name), getattr(ref_a, name), err_msg=name)
    np.testing.assert_array_equal(out_g.numpy(), ref_g)
    i_na = jad.spec_by_name("Na")
    na = (out_a.vol[..., i_na, :] > 0) & (out_a.num > 0)
    assert na[0].sum() > 0 and na[1:].sum() == 0
    before = (np.asarray(aero.num) > 0).sum()
    assert (ref_a.num > 0).sum() > before
