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


# ---- K5's plain version (optics.mie_fit_sums_plain) ------------------------

def _jax_sums(diam, n, k, live_num):
    """The JAX package's per-cell sums [3, W, ...]: its per-particle
    efficiencies (``particle_efficiencies(..., "mie_fit")``) formed into
    cross-sections as ``per_particle_optics`` forms them."""
    area = (jnp.pi / 4.0) * diam * diam
    bands = []
    for wl in joptics.WAVELENGTHS:
        q_ext, q_sca, g = joptics.particle_efficiencies(diam, n, k, wl, "mie_fit")
        c_sca = q_sca * area
        bands.append(jnp.stack([jnp.sum(c_sca * live_num, -1),
                                jnp.sum((q_ext - q_sca) * area * live_num, -1),
                                jnp.sum(c_sca * g * live_num, -1)]))
    return jnp.stack(bands, 1)


def _fields(sums):
    """Extinction, single-scattering albedo and asymmetry from [3, W, ...]
    sums, as ``bulk_optical_props`` forms them (unit volume and depth)."""
    s_sca, s_abs, s_g = (np.asarray(s, np.float64) for s in sums)
    ext = s_sca + s_abs
    return {"tauaer": ext, "waer": s_sca / np.maximum(ext, 1e-30),
            "gaer": s_g / np.maximum(s_sca, 1e-30)}


def test_mie_fit_sums_plain_on_pop(pop):
    """On the population of ``pop`` (x 0.06-21, inside the fit's domain):
    every per-cell sum and the bulk fields to rtol 2e-5 with a floor of
    1e-6 of each row's scale, against the reference's per-particle optics
    summed, and ``bulk_optical_props`` to the same bound."""
    ad, st, dz, V, tad, tst = pop
    c_sca, c_abs, g = jax.jit(lambda s: joptics.per_particle_optics(
        s, ad, method="mie_fit"))(st)
    live = np.where(st.alive, st.num, 0.0).astype(np.float32)
    ref = np.stack([np.sum(np.asarray(c_sca) * live, -1), np.sum(np.asarray(c_abs) * live, -1),
                    np.sum(np.asarray(c_sca) * np.asarray(g) * live, -1)])
    diam = torch.clamp(tst.wet_diameter(), min=1e-9)
    n, k = optics.particle_refractive_index(tst, tad)
    out = optics.mie_fit_sums_plain(diam, n, k, torch.tensor(live))
    assert out.shape == (3, 4, *CELLS)
    for q in range(3):
        for b in range(4):
            close(out[q, b], ref[q, b], rtol=2e-5, err_msg=f"sum {q} band {b}")
    ref_b = jax.jit(lambda s: joptics.bulk_optical_props(s, ad, dz, V))(st)
    out_b = optics.bulk_optical_props(tst, tad, torch.tensor(dz), torch.tensor(V))
    for name in ("tauaer", "waer", "gaer"):
        close(getattr(out_b, name), getattr(ref_b, name), rtol=2e-5, err_msg=name)


def _whole_domain(seed):
    """[2, 3, 4] cells of 16 slots: diameters for x from 1e-4 to 1e3 at the
    four bands, n from 1.0 to 2.2, k 0, 1 or 1e-5 to 1, dead slots, and an
    empty cell."""
    r = np.random.default_rng(seed)
    sh = (2, 3, 4, 16)
    f32 = lambda a: np.asarray(a, np.float32)
    diam = f32(10.0 ** r.uniform(np.log10(1e-4 * 3e-7 / np.pi), np.log10(1e3 * 1e-6 / np.pi), sh))
    n = f32(r.uniform(1.0, 2.2, sh))
    k = f32(np.select([r.random(sh) < 0.25, r.random(sh) < 0.3], [0.0, 1.0],
                      10.0 ** r.uniform(-5.0, 0.0, sh)))
    num = f32(r.uniform(1e6, 1e8, sh) * (r.random(sh) < 0.8))
    num[0, 0, 0] = 0.0
    return diam, n, k, num


@pytest.mark.parametrize("seed", [0, 1])
def test_mie_fit_sums_plain_whole_domain(seed):
    """Over and beyond the fit's whole domain: the bulk fields to rtol 2e-3
    with a floor of 1e-6 of each field's scale.  Near t = +-1 (x near 1e-3
    and 500) the fit amplifies a last-ulp difference of log10 x between the
    frameworks some 10^4 times, and at the corners of (n, k) it reaches
    log10 q of +-30, where the float32 900-term sums carry ~1e-4 of
    log10 q; measured up to 4.5e-4 on such populations.  The empty cell
    sums to exactly 0."""
    diam, n, k, num = _whole_domain(seed)
    ref = np.asarray(jax.jit(_jax_sums)(diam, n, k, num))
    out = optics.mie_fit_sums_plain(*map(torch.tensor, (diam, n, k, num))).numpy()
    assert out.shape == ref.shape == (3, 4, 2, 3, 4)
    assert (out[..., 0, 0, 0] == 0.0).all()
    got, want = _fields(out), _fields(ref)
    for name in want:
        close(got[name], want[name], rtol=2e-3, err_msg=name)


def test_bulk_optics_on_cpu_launches_no_kernel(pop):
    _, _, dz, V, tad, tst = pop
    from wrf_partmc_tpu_torch.ops import mie_fit

    mie_fit.mie_fit_bulk.launches = 0
    optics.bulk_optical_props(tst, tad, torch.tensor(dz), torch.tensor(V), method="mie_fit")
    assert mie_fit.mie_fit_bulk.launches == 0


def test_mie_fit_bulk_refuses_bad_inputs():
    from wrf_partmc_tpu_torch.ops import mie_fit

    x = torch.ones((6, 8))
    coeffs = mie._fit_coeffs("cpu")
    wl = optics.WAVELENGTHS
    with pytest.raises(ValueError, match="CUDA tensor"):
        mie_fit.mie_fit_bulk(x, x, x, x, coeffs, wl)
    with pytest.raises(ValueError, match=r"\[C, P\]"):
        mie_fit.mie_fit_bulk(x, x, x, torch.ones((6, 7)), coeffs, wl)
    with pytest.raises(ValueError, match=r"\[C, P\]"):
        mie_fit.mie_fit_bulk(*[torch.ones(48)] * 4, coeffs, wl)
    with pytest.raises(ValueError, match="float32"):
        mie_fit.mie_fit_bulk(x.double(), x, x, x, coeffs, wl)
    with pytest.raises(ValueError, match="coeffs"):
        mie_fit.mie_fit_bulk(x, x, x, x, coeffs[:, :44].contiguous(), wl)
    with pytest.raises(ValueError, match="wavelengths"):
        mie_fit.mie_fit_bulk(x, x, x, x, coeffs, wl + (1.2e-6,))
