"""Aerosol optics of the port against the JAX package: the Mie table and
its Chebyshev fit, the per-particle efficiencies (table, fit, ADT), the
refractive-index mixing rules, the bulk tauaer/waer/gaer, and the
photolysis attenuation that MOSAIC takes as ``j_scale``.

The table build and the least-squares fit are the same numpy code in both
packages, so their outputs are compared for equality.  Lookups and sums run
in float32 on both sides: the table lookup to rtol 1e-5, the fit and ADT at
the bounds their tests give with the reason, the refractive indices to
rtol 1e-6, bulk fields to rtol 1e-4 with a floor of 1e-6 of the field's
scale.  The MOSAIC step with ``j_scale`` is held at the tolerances of
``tests/test_torch_chem_mosaic.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.models.partmc import aero_state as jaero
from wrf_partmc_tpu.models.partmc import mie as jmie
from wrf_partmc_tpu.models.partmc import mosaic as jmosaic
from wrf_partmc_tpu.models.partmc import optics as joptics
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.cbmz import build_mechanism as jax_build_mechanism
from wrf_partmc_tpu.models.partmc.env_state import make_env_state
from wrf_partmc_tpu.models.partmc.gas_data import make_gas_data_cbmz as jax_make_gas_data_cbmz
from wrf_partmc_tpu.models.physics.radiation import photolysis_aerosol_factor as jax_jfactor

from wrf_partmc_tpu_torch.convert import from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.partmc import mie, mosaic, optics
from wrf_partmc_tpu_torch.models.partmc.cbmz import build_mechanism
from wrf_partmc_tpu_torch.models.partmc.gas_data import make_gas_data_cbmz
from wrf_partmc_tpu_torch.models.physics.radiation import photolysis_aerosol_factor

CELLS, P = (3, 2, 4), 16


def close(out, ref, rtol=1e-4, floor=1e-6, err_msg=""):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=floor * (float(np.abs(ref).max()) + 1e-30),
                               err_msg=err_msg)


def test_mie_table_and_fit_coefficients_equal():
    for a, b in zip(mie._build_table_np(), jmie._build_table_np()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mie._fit_coeffs_np(), jmie._fit_coeffs_np())
    x = np.array([0.01, 0.3, 1.0, 4.0, 25.0])
    m = np.array([1.33 + 0j, 1.5 + 0.01j, 1.82 + 0.74j, 1.45 + 0j, 1.53 + 0.006j])
    for a, b in zip(mie.mie_series(x, m), jmie.mie_series(x, m)):
        np.testing.assert_array_equal(a, b)
    assert mie._cache_path() != getattr(jmie, "_cache_path", lambda: None)()


def _xnk(seed=0, n=4000, lx=(-3.0, 2.7), lk=(-4.0, 0.0)):
    """Size parameters and refractive indices over the table's domain."""
    r = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(10.0 ** r.uniform(*lx, n)), f32(r.uniform(1.25, 1.95, n)),
            f32(10.0 ** r.uniform(*lk, n)))


def test_fit_lookup():
    """Over the fit's domain (x in [1e-2, 1e2]): q_ext to rtol 2e-5 (10**s
    turns the last-ulp differences of the 900-term sum s into ~5e-6
    relative), q_sca = max(q_ext - q_abs, 0) to 2e-5 of q_ext (it cancels
    in the Rayleigh regime), g to 2e-6 absolute."""
    x, n, k = _xnk(lx=(-2.0, 2.0))
    ref = [np.asarray(a) for a in jax.jit(jmie.fit_lookup)(x, n, k)]
    out = [a.numpy() for a in mie.fit_lookup(*map(torch.tensor, (x, n, k)))]
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-5, atol=0.0)
    assert (np.abs(out[1] - ref[1]) <= 2e-5 * ref[0]).all()
    np.testing.assert_allclose(out[2], ref[2], rtol=0.0, atol=2e-6)


def test_table_lookup():
    x, n, k = _xnk(1)
    jt = jmie.make_mie_table()
    ref = jax.jit(lambda *a: jmie.table_lookup(jt, *a))(x, n, k)
    out = mie.table_lookup(mie.make_mie_table(), *map(torch.tensor, (x, n, k)))
    for o, rr, name in zip(out, ref, ("q_ext", "q_sca", "g")):
        close(o, rr, rtol=1e-5, err_msg=name)


def _population(ad):
    """Random compositions (BC, OC, dust, sulfate, water), sizes 20 nm to
    2 um, and dead slots."""
    r = np.random.default_rng(2)
    S = ad.n_spec
    frac = r.dirichlet(np.ones(S), (*CELLS, P)) * (r.random((*CELLS, P, S)) < 0.4)
    frac[..., ad.spec_by_name("BC")] += 0.2 * r.random((*CELLS, P))
    frac[..., ad.spec_by_name("H2O")] += r.random((*CELLS, P))
    frac /= frac.sum(-1, keepdims=True)
    v = np.pi / 6 * (10.0 ** r.uniform(-7.7, -5.7, (*CELLS, P))) ** 3
    num = r.uniform(1e15, 1e17, (*CELLS, P)) * (r.random((*CELLS, P)) < 0.85)
    vol = np.moveaxis(frac * v[..., None], -1, -2) * (num[..., None, :] > 0)
    st = jax.tree.map(np.asarray, jaero.zero_state(ad, P, CELLS))
    return dataclasses.replace(st, vol=vol.astype(np.float32), num=num.astype(np.float32))


@pytest.fixture(scope="module")
def pop():
    ad = jax_make_aero_data()
    st = _population(ad)
    dz = np.array([60.0, 90.0, 140.0], np.float32)
    V = (4000.0 * 4000.0 * dz.reshape(-1, 1, 1) * np.ones(CELLS)).astype(np.float32)
    return ad, st, dz, V, from_numpy(jax.tree.map(np.asarray, ad)), from_numpy(st)


@pytest.mark.parametrize("mg", [False, True], ids=["volume-mix", "maxwell-garnett"])
def test_particle_refractive_index(pop, mg):
    ad, st, _, _, tad, tst = pop
    # the reference's Maxwell-Garnett branch reads the BC index on the host,
    # so it runs eagerly
    ref = joptics.particle_refractive_index(jax.tree.map(jnp.asarray, st), ad,
                                            maxwell_garnett=mg)
    out = optics.particle_refractive_index(tst, tad, maxwell_garnett=mg)
    close(out[0], ref[0], rtol=1e-6, err_msg="n")
    close(out[1], ref[1], rtol=2e-6, floor=1e-7, err_msg="k")


@pytest.mark.parametrize("method", ["mie_fit", "mie", "adt"])
def test_bulk_optical_props(pop, method):
    ad, st, dz, V, tad, tst = pop
    ref = jax.jit(lambda s: joptics.bulk_optical_props(s, ad, dz, V, method=method))(st)
    out = optics.bulk_optical_props(tst, tad, torch.tensor(dz), torch.tensor(V),
                                    method=method)
    for name in ("tauaer", "waer", "gaer"):
        close(getattr(out, name), getattr(ref, name), err_msg=name)
    assert float(np.asarray(ref.tauaer).min()) > 0.0
    bs, ba = optics.scat_abs_coeffs(tst, tad, torch.tensor(V), method=method)
    rbs, rba = jax.jit(lambda s: joptics.scat_abs_coeffs(s, ad, V, method=method))(st)
    close(bs, rbs, err_msg="b_sca")
    close(ba, rba, err_msg="b_abs")


def test_adt_efficiencies():
    """ADT's closed-form absorption cancels catastrophically in float32 for
    z = 4 x k below ~0.1 (terms of 2/z^2 cancel to ~2z/3), where the two
    frameworks' last ulps give unrelated values; compared at z >= 0.2."""
    x, n, k = _xnk(3, lx=(0.0, 2.0), lk=(-1.3, 0.0))
    diam = x * 5.5e-7 / np.pi
    ref = jax.jit(lambda *a: joptics.adt_efficiencies(*a, 5.5e-7))(diam, n, k)
    out = optics.adt_efficiencies(*map(torch.tensor, (diam, n, k)), 5.5e-7)
    for o, rr in zip(out, ref):
        close(o, rr, rtol=1e-4)


# ---- MOSAIC with the aerosol attenuation of photolysis ---------------------

GASES = dict(H2SO4=0.5, HNO3=2.0, NH3=4.0, O3=40.0, NO2=10.0, NO=2.0, SO2=5.0,
             HCHO=2.0, CO=150.0, CH4=1800.0, ISOP=1.0, API1=0.4)


def test_mosaic_timestep_with_j_scale(pop):
    """The j_scale of a polluted column cuts the actinic flux in the lowest
    cells; the day-time CBM-Z + ASTEM + SOA step with it, against
    the reference with the same factor (gases rtol 1e-3, per-cell species
    volume rtol 5e-3, as the MOSAIC parity test)."""
    ad, st, dz, V, tad, tst = pop
    gd = jax_make_gas_data_cbmz()
    r = np.random.default_rng(4)
    env = jax.tree.map(np.asarray, make_env_state(cell_shape=CELLS))
    env = dataclasses.replace(
        env, temp=r.uniform(280.0, 300.0, CELLS).astype(np.float32),
        pressure=r.uniform(8.5e4, 1.0e5, CELLS).astype(np.float32),
        rel_humid=r.uniform(0.4, 0.9, CELLS).astype(np.float32),
        cell_volume=V)
    gas = np.zeros((*CELLS, 77), np.float32)
    for name, ppb in GASES.items():
        gas[..., gd.spec_by_name(name)] = ppb * r.uniform(0.5, 1.5, CELLS)
    optic = jax.jit(lambda s: joptics.bulk_optical_props(s, ad, dz, V))(st)
    cosz = 0.6
    js_ref = jax.jit(lambda o: jax_jfactor(o.tauaer, o.waer, o.gaer, jnp.float32(cosz)))(optic)
    js = photolysis_aerosol_factor(*(torch.tensor(np.asarray(getattr(optic, f)))
                                     for f in ("tauaer", "waer", "gaer")), torch.tensor(cosz))
    close(js, js_ref, rtol=1e-5)
    assert float(np.asarray(js_ref).min()) < 0.95
    jm = jax_build_mechanism()
    ref = jax.jit(lambda a, g, e, j: jmosaic.mosaic_timestep(
        jm, a, g, gd, ad, e, 300.0, jnp.float32(cosz), j_scale=j))(st, gas, env, js_ref)
    out = mosaic.mosaic_timestep(build_mechanism(), tst, torch.tensor(gas),
                                 make_gas_data_cbmz(), tad, from_numpy(env), 300.0,
                                 torch.tensor(cosz), j_scale=js)
    plain = jax.jit(lambda a, g, e: jmosaic.mosaic_timestep(
        jm, a, g, gd, ad, e, 300.0, jnp.float32(cosz)))(st, gas, env)
    rg, og, pg = np.asarray(ref[1]), out[1].numpy(), np.asarray(plain[1])
    np.testing.assert_allclose(og, rg, rtol=1e-3, atol=1e-5 * gas.max() + 1e-9)
    o3 = gd.spec_by_name("O3")
    assert np.abs(rg[..., o3] - pg[..., o3]).max() > 1e-3     # the attenuation mattered
    ra, oa = jax.tree.map(np.asarray, ref[0]), to_numpy(out[0])
    np.testing.assert_array_equal(oa.num, ra.num)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(oa), sv(ra), rtol=5e-3, atol=1e-6 * sv(ra).sum(-1).max())
