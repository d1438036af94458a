"""MOSAIC aerosol chemistry of the port against the JAX package under
``jax.jit``: ASTEM inorganic transfer, SOA partitioning and the whole
``mosaic_timestep``, on one population made from a seed.

The population spans the MESA-lite regimes in every cell: acidic sulfate,
ammonium sulfate, sea salt, organic carbon and nitrate-bearing particles,
some on the effloresced hysteresis leg (solid-phase NH4NO3 Kp) and some on
the deliquesced one (aqueous Kp), plus dead slots.

ASTEM is not smooth in its inputs.  Its MESA-lite gate switches a particle
between the acidic, neutral and salt regimes on the sign of its ion
balance, and acidic particles taking up NH3 end each substep at that sign
change; its Kp fits cancel large terms in log space.  A last-ulp difference
of log or exp between XLA-CPU and torch can therefore move a near-neutral
particle to the other regime for a substep.  The tolerances say so:

* per cell and species, the represented volume (vol x num): rtol 5e-3 with
  a floor of 1e-6 of the cell's total;
* gases: rtol 1e-3 with a floor of 1e-5 of the initial mixing ratio
  (a gas taken up in full leaves a residual of a few of its ulps);
* per particle and species: every alive entry within rtol 1e-4 plus 3e-3
  of the particle's volume, and at least 98% of them within rtol 1e-4 plus
  1e-6 of the particle's volume.

The gas<->particle totals are conserved to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.models.partmc import aero_state as jaero
from wrf_partmc_tpu.models.partmc import mosaic as jmosaic
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.cbmz import build_mechanism as jax_build_mechanism
from wrf_partmc_tpu.models.partmc.env_state import make_env_state
from wrf_partmc_tpu.models.partmc.gas_data import make_gas_data_cbmz as jax_make_gas_data_cbmz

from wrf_partmc_tpu_torch.convert import from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.partmc import mosaic
from wrf_partmc_tpu_torch.models.partmc.cbmz import build_mechanism
from wrf_partmc_tpu_torch.models.partmc.gas_data import make_gas_data_cbmz

CELLS, P = (2, 3), 24
GASES = dict(H2SO4=0.5, HNO3=2.0, HCl=0.5, NH3=4.0, MSA=0.05, SULFHOX=0.02,
             O3=40.0, NO2=10.0, NO=2.0, SO2=5.0, HCHO=2.0, CO=150.0, CH4=1800.0,
             ARO1=0.3, ARO2=0.5, ALK1=0.2, OLE1=0.1, API1=0.4, API2=0.6, LIM1=0.2,
             LIM2=0.3, ISOP=1.0, DMS=0.1)


def _population(ad):
    """Per cell: 6 acidic sulfate, 6 ammonium sulfate, 3 sea salt, 4 OC and
    3 nitrate-bearing particles, 2 dead slots, random sizes and legs."""
    r = np.random.default_rng(0)
    S = ad.n_spec
    sp = ad.spec_by_name
    vol = np.zeros((*CELLS, S, P), np.float32)
    num = np.zeros((*CELLS, P), np.float32)
    for idx in np.ndindex(CELLS):
        v = np.pi / 6 * r.uniform(0.05e-6, 0.4e-6, P) ** 3
        kinds = [("SO4",)] * 6 + [("SO4", "NH4")] * 6 + [("Na", "Cl")] * 3 \
            + [("OC",)] * 4 + [("NH4", "NO3", "SO4")] * 3
        for i, kind in enumerate(kinds):
            w = r.uniform(0.5, 1.5, len(kind))
            for name, wi in zip(kind, w / w.sum()):
                vol[idx][sp(name), i] = v[i] * wi
            vol[idx][sp("H2O"), i] = 0.3 * v[i] * r.random()
            num[idx][i] = r.uniform(1e6, 5e6) if kind[0] == "Na" else r.uniform(1e7, 1e8)
    st = jax.tree.map(np.asarray, jaero.zero_state(ad, P, CELLS))
    leg = r.integers(0, 2, (*CELLS, P)).astype(np.int32)
    return dataclasses.replace(st, vol=vol, num=num, hyst_leg=leg)


@pytest.fixture(scope="module")
def case():
    ad, gd = jax_make_aero_data(), jax_make_gas_data_cbmz()
    r = np.random.default_rng(1)
    env = jax.tree.map(np.asarray, make_env_state(cell_shape=CELLS))
    env = dataclasses.replace(
        env, temp=r.uniform(275.0, 300.0, CELLS).astype(np.float32),
        pressure=r.uniform(8.5e4, 1.01e5, CELLS).astype(np.float32),
        rel_humid=r.uniform(0.4, 0.9, CELLS).astype(np.float32),
        cell_volume=np.ones(CELLS, np.float32))
    gas = np.zeros((*CELLS, 77), np.float32)
    for name, ppb in GASES.items():
        gas[..., gd.spec_by_name(name)] = ppb * r.uniform(0.5, 1.5, CELLS)
    aero = _population(ad)
    j = dict(ad=ad, gd=gd, env=env, gas=gas, aero=aero)
    t = dict(ad=from_numpy(jax.tree.map(np.asarray, ad)), gd=make_gas_data_cbmz(),
             env=from_numpy(env), gas=torch.tensor(gas), aero=from_numpy(aero))
    return j, t


def _check(ref, out, gas0):
    """ref: the reference's (aero, gas); out: the port's; gas0: the input."""
    ra, rg = jax.tree.map(np.asarray, ref[0]), np.asarray(ref[1])
    oa, og = to_numpy(out[0]), out[1].numpy()
    np.testing.assert_array_equal(oa.num, ra.num)
    np.testing.assert_array_equal(oa.hyst_leg, ra.hyst_leg)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(oa), sv(ra), rtol=5e-3,
                               atol=1e-6 * sv(ra).sum(-1).max())
    np.testing.assert_allclose(og, rg, rtol=1e-3, atol=1e-5 * gas0.max() + 1e-9)
    alive = np.broadcast_to(ra.num[..., None, :] > 0, ra.vol.shape)
    pvol = ra.vol.sum(-2, keepdims=True)
    d = np.abs(oa.vol - ra.vol) - 1e-4 * np.abs(ra.vol)
    assert (d <= 3e-3 * pvol)[alive].all(), (d / pvol)[alive].max()
    assert (d <= 1e-6 * pvol)[alive].mean() >= 0.98
    assert np.isfinite(og).all()
    return ra, rg


def _conserved(aero, gas, gd, ad, env, gname, aname):
    """Domain mol of one gas + its aerosol species (gas at cell T, P)."""
    ig, sa = gd.spec_by_name(gname), ad.spec_by_name(aname)
    gmol = gas[..., ig] * 1e-9 * env.pressure / (8.314462618 * env.temp)
    amol = (aero.vol[..., sa, :] * np.asarray(ad.density)[sa]
            / np.asarray(ad.molec_weight)[sa] * aero.num).sum(-1)
    return float((gmol + amol).sum())


def test_astem_inorganic(case):
    j, t = case
    ref = jax.jit(lambda a, g, e: jmosaic.astem_inorganic(a, g, j["gd"], j["ad"], e, 300.0))(
        j["aero"], j["gas"], j["env"])
    out = mosaic.astem_inorganic(t["aero"], t["gas"], t["gd"], t["ad"], t["env"], 300.0)
    ra, rg = _check(ref, out, j["gas"])
    # every regime moved mass: sulfate grew, ammonium moved, chloride shed
    dv = ra.vol - j["aero"].vol
    for name in ("SO4", "NH4", "NO3", "Cl"):
        assert np.abs(dv[..., j["ad"].spec_by_name(name), :]).max() > 0, name
    oa, og = to_numpy(out[0]), out[1].numpy()
    for gname, aname in (("NH3", "NH4"), ("HNO3", "NO3")):
        before = _conserved(j["aero"], j["gas"], j["gd"], j["ad"], j["env"], gname, aname)
        after = _conserved(oa, og, j["gd"], j["ad"], j["env"], gname, aname)
        assert abs(after - before) <= 1e-5 * before, gname


def test_soa_partition(case):
    j, t = case
    ref = jax.jit(lambda a, g, e: jmosaic.soa_partition(a, g, j["gd"], j["ad"], e, 300.0))(
        j["aero"], j["gas"], j["env"])
    out = mosaic.soa_partition(t["aero"], t["gas"], t["gd"], t["ad"], t["env"], 300.0)
    ra, _ = _check(ref, out, j["gas"])
    assert ra.vol[..., j["ad"].spec_by_name("API1"), :].max() > 0


@pytest.mark.parametrize("cosz", [0.6, -0.3], ids=["day", "night"])
def test_mosaic_timestep(case, cosz):
    """The macro-step as the coupled step calls it.  The trace gases carry
    DMS, whose OH-addition channel the jitted reference flushes to 0
    (``test_torch_chem_cbmz``): the port's DMS is lower by that channel's
    ~0.1% over 300 s (rtol 3e-3), its products are left out, and the rest
    is held at the module tolerance."""
    j, t = case
    jm = jax_build_mechanism()
    ref = jax.jit(lambda a, g, e: jmosaic.mosaic_timestep(
        jm, a, g, j["gd"], j["ad"], e, 300.0, jnp.float32(cosz)))(j["aero"], j["gas"], j["env"])
    out = mosaic.mosaic_timestep(build_mechanism(), t["aero"], t["gas"], t["gd"], t["ad"],
                                 t["env"], 300.0, torch.tensor(cosz))
    gd = j["gd"]
    dms = [gd.spec_by_name(n) for n in ("DMS", "DMSO", "CH3SO2H", "DMSO2", "CH3SO2")]
    og = out[1].numpy()
    rg = np.asarray(ref[1])
    np.testing.assert_allclose(og[..., dms[0]], rg[..., dms[0]], rtol=3e-3)
    og[..., dms] = rg[..., dms]
    _check(ref, (out[0], torch.tensor(og)), j["gas"])
