"""Water uptake, condensation, nucleation and the simple chemistry of the
port against the JAX package under ``jax.jit``, on one population made from
a seed (2x3 cells, 24 slots, 3 of them dead).

Tolerances: leg flags, alive masks and integer fields exact; other floats
rtol 1e-5, equilibrium water rtol 1e-4 with a floor of 1e-6 of the cell's
largest particle (20 cube-root fixed-point iterations).

Two reference solvers are ill-conditioned in float32, and their tests say
where:

* ``condense_dynamic`` damps Newton steps on differences of near-equal
  masses.  In the supersaturated cell (RH 1.005) the reference's own jit
  and eager runs differ by 17% in a particle's water, so that cell is held
  only by its saturation ratio; the subsaturated cells' water agrees to
  rtol 5e-3 with the floor above.
* ``crit_supersat`` takes a central difference of float32 gradients for its
  Newton curvature.  For near-insoluble particles (kappa < 0.1) that
  difference is noise and the reference returns negative critical
  supersaturations, so the comparison (rtol 1e-3) covers the hygroscopic
  particles, and the CCN counts may differ only by particles that are
  near-insoluble or within 1e-3 of a threshold.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.models.partmc import aero_state as jaero
from wrf_partmc_tpu.models.partmc import condense as jcondense
from wrf_partmc_tpu.models.partmc import nucleate as jnucleate
from wrf_partmc_tpu.models.partmc import simple_chem as jsimple
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.aero_data import solute_kappa as jax_solute_kappa
from wrf_partmc_tpu.models.partmc.env_state import make_env_state
from wrf_partmc_tpu.models.partmc.gas_data import make_gas_data as jax_make_gas_data

from wrf_partmc_tpu_torch.convert import from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.partmc import condense, nucleate, simple_chem
from wrf_partmc_tpu_torch.models.partmc.gas_data import make_gas_data

CELLS, P = (2, 3), 24
KINDS = [("SO4",)] * 5 + [("SO4", "NH4")] * 5 + [("Na", "Cl")] * 3 + [("OC",)] * 3 \
    + [("NH4", "NO3")] * 3 + [("OC", "BC", "SO4")] * 2


@pytest.fixture(scope="module")
def case():
    ad, gd = jax_make_aero_data(), jax_make_gas_data()
    r = np.random.default_rng(0)
    vol = np.zeros((*CELLS, ad.n_spec, P), np.float32)
    num = np.zeros((*CELLS, P), np.float32)
    for idx in np.ndindex(CELLS):
        v = np.pi / 6 * r.uniform(0.03e-6, 0.5e-6, P) ** 3
        for i, kind in enumerate(KINDS):
            w = r.uniform(0.5, 1.5, len(kind))
            for name, wi in zip(kind, w / w.sum()):
                vol[idx][ad.spec_by_name(name), i] = v[i] * wi
            vol[idx][ad.i_water, i] = 0.5 * v[i] * r.random()
            num[idx][i] = r.uniform(1e6, 1e8)
    aero = dataclasses.replace(jax.tree.map(np.asarray, jaero.zero_state(ad, P, CELLS)),
                               vol=vol, num=num,
                               hyst_leg=r.integers(0, 2, (*CELLS, P)).astype(np.int32),
                               next_id=np.full(CELLS, P, np.int32))
    env = dataclasses.replace(
        jax.tree.map(np.asarray, make_env_state(cell_shape=CELLS)),
        temp=r.uniform(275.0, 300.0, CELLS).astype(np.float32),
        pressure=r.uniform(8.5e4, 1.01e5, CELLS).astype(np.float32),
        # RH across every leg: below CRH, between, above DRH, supersaturated
        rel_humid=np.array([[0.2, 0.5, 0.7], [0.85, 0.95, 1.005]], np.float32),
        cell_volume=np.full(CELLS, 2.0, np.float32))
    gas = np.zeros((*CELLS, gd.n_spec), np.float32)
    for name, ppb in dict(SO2=5.0, H2SO4=0.8, NH3=2.0, HNO3=1.0).items():
        gas[..., gd.spec_by_name(name)] = ppb * r.uniform(0.5, 1.5, CELLS)
    j = dict(ad=ad, gd=gd, env=env, gas=gas, aero=aero)
    t = dict(ad=from_numpy(jax.tree.map(np.asarray, ad)), gd=make_gas_data(),
             env=from_numpy(env), gas=torch.tensor(gas), aero=from_numpy(aero))
    return j, t


def _water_close(ref, out, i_water):
    floor = 1e-6 * ref.vol.sum(-2).max(-1)[..., None]
    d = np.abs(out.vol[..., i_water, :] - ref.vol[..., i_water, :])
    assert (d <= 1e-4 * np.abs(ref.vol[..., i_water, :]) + floor).all(), d.max()
    dry = np.arange(ref.vol.shape[-2]) != i_water
    np.testing.assert_array_equal(out.vol[..., dry, :], ref.vol[..., dry, :])


def test_particle_drh_crh(case):
    j, t = case
    ref = [np.asarray(a) for a in jax.jit(lambda a: jcondense.particle_drh_crh(a, j["ad"]))(
        j["aero"])]
    out = [a.numpy() for a in condense.particle_drh_crh(t["aero"], t["ad"])]
    for r_, o in zip(ref, out):
        np.testing.assert_allclose(o, r_, rtol=1e-5, equal_nan=True)


@pytest.mark.parametrize("hyst", [False, True], ids=["equilib_water", "equilib_water_hyst"])
def test_equilib_water(case, hyst):
    j, t = case
    jfn = jcondense.equilib_water_hyst if hyst else jcondense.equilib_water
    fn = condense.equilib_water_hyst if hyst else condense.equilib_water
    ref = jax.tree.map(np.asarray, jax.jit(lambda a, e: jfn(a, j["ad"], e))(j["aero"], j["env"]))
    out = to_numpy(fn(t["aero"], t["ad"], t["env"]))
    np.testing.assert_array_equal(out.hyst_leg, ref.hyst_leg)
    if hyst:
        assert set(np.unique(ref.hyst_leg[ref.num > 0])) == {0, 1}
        assert (ref.hyst_leg != j["aero"].hyst_leg).any()
    _water_close(ref, out, j["ad"].i_water)


def test_condense_dynamic(case):
    j, t = case
    ref_a, ref_s = jax.jit(lambda a, e: jcondense.condense_dynamic(a, j["ad"], e, 60.0))(
        j["aero"], j["env"])
    out_a, out_s = condense.condense_dynamic(t["aero"], t["ad"], t["env"], 60.0)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), rtol=1e-5)
    ref_a, out_a = jax.tree.map(np.asarray, ref_a), to_numpy(out_a)
    w = j["ad"].i_water
    sub = j["env"].rel_humid < 1.0
    floor = 1e-6 * ref_a.vol.sum(-2).max(-1)[..., None]
    d = np.abs(out_a.vol[..., w, :] - ref_a.vol[..., w, :])
    assert (d <= 5e-3 * ref_a.vol[..., w, :] + floor)[sub].all()
    dry = np.arange(ref_a.vol.shape[-2]) != w
    np.testing.assert_array_equal(out_a.vol[..., dry, :], ref_a.vol[..., dry, :])


def _hygroscopic(j):
    kap = np.asarray(jax.jit(lambda v: jax_solute_kappa(v, j["ad"]))(j["aero"].vol))
    return (kap >= 0.1) & (j["aero"].num > 0)


def test_state_crit_supersats(case):
    j, t = case
    ref = np.asarray(jax.jit(lambda a, e: jcondense.state_crit_supersats(a, j["ad"], e))(
        j["aero"], j["env"]))
    out = condense.state_crit_supersats(t["aero"], t["ad"], t["env"]).numpy()
    ok = _hygroscopic(j)
    assert ok.sum() >= 15 * 6
    np.testing.assert_allclose(out[ok], ref[ok], rtol=1e-3)


def test_ccn_conc(case):
    j, t = case
    ss = np.array([0.0003, 0.001, 0.003], np.float32)
    ref_sc = np.asarray(jax.jit(lambda a, e: jcondense.state_crit_supersats(a, j["ad"], e))(
        j["aero"], j["env"]))
    ref = np.asarray(jax.jit(lambda a, e: jcondense.ccn_conc(a, j["ad"], e, ss))(
        j["aero"], j["env"]))
    out = condense.ccn_conc(t["aero"], t["ad"], t["env"], ss).numpy()
    free = (~_hygroscopic(j))[..., None, :] | (
        np.abs(ref_sc[..., None, :] - ss[:, None]) <= 1e-3 * ss[:, None])
    slack = (free * j["aero"].num[..., None, :]).sum(-1) / j["env"].cell_volume[..., None]
    assert (np.abs(out - ref) <= slack + 1e-6 * ref).all()
    assert (ref > 0).any() and (ref < j["aero"].num.sum(-1)[..., None] / 2.0).any()


def test_nucleate_step(case):
    j, t = case
    e = j["env"]
    ref_a, ref_g = jax.jit(lambda a, g: jnucleate.nucleate_step(
        a, g, j["gd"], j["ad"], e.temp, e.pressure, e.cell_volume, 300.0))(j["aero"], j["gas"])
    te = t["env"]
    out_a, out_g = nucleate.nucleate_step(t["aero"], t["gas"], t["gd"], t["ad"], te.temp,
                                          te.pressure, te.cell_volume, 300.0)
    ref_a, out_a = jax.tree.map(np.asarray, ref_a), to_numpy(out_a)
    assert (ref_a.num > 0).sum() == (j["aero"].num > 0).sum() + 2 * 6
    np.testing.assert_array_equal(out_a.num > 0, ref_a.num > 0)
    np.testing.assert_allclose(out_a.num, ref_a.num, rtol=1e-5)
    np.testing.assert_allclose(out_a.vol, ref_a.vol, rtol=1e-5, atol=0)
    for name in ("pid", "source", "w_class", "hyst_leg", "next_id"):
        np.testing.assert_array_equal(np.where(ref_a.num > 0, getattr(out_a, name), 0)
                                      if name != "next_id" else out_a.next_id,
                                      np.where(ref_a.num > 0, getattr(ref_a, name), 0)
                                      if name != "next_id" else ref_a.next_id, err_msg=name)
    np.testing.assert_allclose(out_g.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-9)


def test_simple_chem_step(case):
    j, t = case
    ref_a, ref_g = jax.jit(lambda a, g, e: jsimple.chem_step(a, g, j["gd"], j["ad"], e, 300.0))(
        j["aero"], j["gas"], j["env"])
    out_a, out_g = simple_chem.chem_step(t["aero"], t["gas"], t["gd"], t["ad"], t["env"], 300.0)
    ref_a, out_a = jax.tree.map(np.asarray, ref_a), to_numpy(out_a)
    floor = 1e-6 * ref_a.vol.sum(-2).max(-1)[..., None, None]
    assert (np.abs(out_a.vol - ref_a.vol) <= 1e-5 * np.abs(ref_a.vol) + floor).all()
    assert (ref_a.vol[..., 0, :] > j["aero"].vol[..., 0, :]).any()      # sulfate grew
    np.testing.assert_allclose(out_g.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("options", [
    dict(chem_mech="simple", do_nucleation=True, do_coagulation=False,
         do_condensation=True, condense_mode="equilib"),
    dict(chem_mech="cbmz", do_nucleation=False, do_coagulation=True,
         do_condensation=True, condense_mode="dynamic"),
], ids=["nucleation+simple+equilib", "coag+cbmz+dynamic"])
def test_microphysics_step(case, options):
    """The chemistry macro-step of the driver in the reference's order and
    key split: nucleation, coagulation (same threefry bits), chemistry,
    condensation.  Nucleation and coagulation run in separate cases: the
    nucleated 1 nm particles (1e17 per cell at 0.8 ppb H2SO4) make
    coagulation's acceptance tests flip on last-ulp rounding.  Alive masks
    exact, number rtol 1e-5.  With the simple chemistry, gases rtol 1e-4
    and species volumes per cell rtol 1e-4 with a floor of 1e-6 of the
    cell's total; with MOSAIC, the bounds of test_torch_chem_mosaic (ASTEM's
    gate): gases rtol 1e-3 with a floor of 1e-5 of the largest input, cell
    volumes rtol 5e-3."""
    from wrf_partmc_tpu.models.coupled import driver as jdriver
    from wrf_partmc_tpu.models.partmc.gas_data import make_gas_data_cbmz as jax_cbmz_gases

    from wrf_partmc_tpu_torch.entry import GAS_BACKGROUND, make_config
    from wrf_partmc_tpu_torch.models.coupled import driver
    from wrf_partmc_tpu_torch.models.partmc.cbmz import build_mechanism
    from wrf_partmc_tpu_torch.models.partmc.gas_data import make_gas_data_cbmz

    j, t = case
    cbmz = options["chem_mech"] == "cbmz"
    cfg = make_config(12, 12, 4, 16, 48, chem_dt=300.0, chem_on=True)
    cfg = cfg.replace(partmc=dataclasses.replace(cfg.partmc, **options))
    jgd, tgd, gas = j["gd"], t["gd"], j["gas"]
    if cbmz:
        jgd, tgd = jax_cbmz_gases(), make_gas_data_cbmz()
        gas = np.zeros((*CELLS, 77), np.float32)
        for name, ppb in dict(GAS_BACKGROUND, H2SO4=0.5).items():
            gas[..., jgd.spec_by_name(name)] = ppb
    key = jax.random.fold_in(jax.random.key(0), 7)
    ref_a, ref_g, _, _ = jax.jit(lambda a, g, e, k: jdriver.microphysics_step(
        a, g, e, j["ad"], jgd, None, cfg, None, None, jax.numpy.float32(3000.0), k))(
        j["aero"], gas, j["env"], key)
    out_a, out_g = driver.microphysics_step(
        t["aero"], torch.tensor(gas), t["env"], t["ad"], tgd, cfg, 3000.0,
        tuple(int(v) for v in np.asarray(jax.random.key_data(key))),
        mech=build_mechanism() if cbmz else None)
    ref_a, out_a = jax.tree.map(np.asarray, ref_a), to_numpy(out_a)
    np.testing.assert_array_equal(out_a.num > 0, ref_a.num > 0)
    np.testing.assert_allclose(out_a.num, ref_a.num, rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(out_a), sv(ref_a), rtol=5e-3 if cbmz else 1e-4,
                               atol=1e-6 * sv(ref_a).sum(-1).max())
    if cbmz:
        np.testing.assert_allclose(out_g.numpy(), np.asarray(ref_g), rtol=1e-3,
                                   atol=1e-5 * gas.max())
    else:
        np.testing.assert_allclose(out_g.numpy(), np.asarray(ref_g), rtol=1e-4, atol=1e-9)
    assert not np.array_equal(ref_a.num, j["aero"].num)       # particles added or merged
    assert not np.array_equal(np.asarray(ref_g), gas)


@pytest.mark.parametrize("name", ["particle_density", "solute_kappa", "dry_diameter",
                                  "kelvin_A"])
def test_property_helpers(case, name):
    """The AeroData / AeroState / EnvState helpers chemistry and
    condensation read, rtol 1e-6 (dead slots' 0/0 is NaN on both sides)."""
    from wrf_partmc_tpu.models.partmc import aero_data as jad

    from wrf_partmc_tpu_torch.models.partmc import aero_data as tad

    j, t = case
    ref, out = {
        "particle_density": lambda: (jad.particle_density(j["aero"].vol, j["ad"]),
                                     tad.particle_density(t["aero"].vol, t["ad"])),
        "solute_kappa": lambda: (jad.solute_kappa(j["aero"].vol, j["ad"]),
                                 tad.solute_kappa(t["aero"].vol, t["ad"])),
        "dry_diameter": lambda: (jax.tree.map(jax.numpy.asarray, j["aero"]).dry_diameter(
            j["ad"]), t["aero"].dry_diameter(t["ad"])),
        "kelvin_A": lambda: (jax.tree.map(jax.numpy.asarray, j["env"]).kelvin_A,
                             t["env"].kelvin_A),
    }[name]()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, equal_nan=True)
