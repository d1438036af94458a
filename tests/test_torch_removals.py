"""Removal bookkeeping of the port's coupled step against the JAX
package's ``coupled_step(diag_out=True)``: the ``record_removals`` counters
per cause and the ``record_aero_info`` coagulation records.

The state is ``run.build_model``'s em_uniform case at 8x8x3 cells, 16
particles per cell (capacity 32), with its multiplicities scaled by 1e4,
so that a 600 s coagulation step pairs off dozens of particles, and its
diameters by 1000 (100 um, settling at about 0.5 m/s), so that dry
deposition removes some particles in two steps; it is stepped
with 6 ideal particles per cell (cells of 12 or more are halved), a
dilution rate of 1e-3 s-1 and open x boundaries (outflow).  Step 0 runs
the coagulation; step 1 does not.  All the JAX steps come from one
``jax.jit``.

The coagulation records must be equal.  A counter is the difference of a
cell's represented number before and after a process.  Per-cell numbers
agree between the frameworks to about 1e-5 (tests/test_torch_coupled.py),
and the reference's fused sums leave round-off of about 1e-6 of the
cell's number at the time of the process even where the process removed
nothing; within a step transport can bring up to the largest cell's number
into any cell.  So each counter is held per cell to rtol 1e-4 with an
absolute floor of 1e-5 of the largest cell number of the domain over the
step, and its domain total to rtol 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from wrf_partmc_tpu.config import (BoundaryConfig, DomainConfig, PartmcConfig,
                                   uniform_test_config)
from wrf_partmc_tpu.models.coupled.driver import coupled_step as jax_coupled_step
from wrf_partmc_tpu.models.partmc.dist import make_mode as jax_make_mode
from wrf_partmc_tpu.models.partmc.scenario import constant_scenario as jax_constant_scenario
from wrf_partmc_tpu.run import build_model as jax_build_model
from wrf_partmc_tpu.utils import rng as jax_rng
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.entry import build
from wrf_partmc_tpu_torch.models.coupled.driver import (REMOVAL_CAUSES, TRANSPORT_COUNTERS,
                                                        CoupledModel)

N_STEPS = 2


def _cfg(num_particles):
    cfg = uniform_test_config().replace(
        domain=DomainConfig(nx=8, ny=8, nz=3, dx=2000.0, dy=2000.0, ztop=2000.0),
        boundary=BoundaryConfig(periodic_x=False, open_xs=True, open_xe=True),
        partmc=PartmcConfig(num_particles=num_particles, max_particles=32, n_emit_slots=4,
                            partmc_chem_dt=600.0, do_coagulation=True, do_emission=True,
                            do_deposition=True, do_transport=True, record_removals=True,
                            record_aero_info=True))
    return cfg.replace(dynamics=dataclasses.replace(cfg.dynamics, constant_velocity=False))


@pytest.fixture(scope="module")
def runs():
    grid, ad, gd, _, cs, exch, _ = jax_build_model(_cfg(16), "uniform")
    cfg = _cfg(6)
    vf = np.zeros(ad.n_spec)
    vf[ad.spec_by_name("SO4")] = 1.0
    scn = jax_constant_scenario(ad, gd.n_spec, jax_make_mode(0.0, 1e-7, 1.6, vf),
                                dilution_rate=1e-3)
    cs = dataclasses.replace(cs, aero=dataclasses.replace(
        cs.aero, num=cs.aero.num * 1e4, vol=cs.aero.vol * 1e9, src_vol=cs.aero.src_vol * 1e9))
    key = jax_rng.base_key(0)
    step = jax.jit(lambda c: jax_coupled_step(c, grid, cfg, ad, gd, scn, exch, key,
                                              diag_out=True))
    host = lambda t: jax.tree.map(np.asarray, t)
    model = CoupledModel(config_from_reference(cfg), from_numpy(host(grid)),
                         from_numpy(host(ad)), from_numpy(host(gd)), from_numpy(host(scn)),
                         from_numpy(host(exch)), seed=0)
    state = from_numpy(host(cs))
    ref, out = [(host(cs), None)], [(to_numpy(state), None)]
    for _ in range(N_STEPS):
        cs, diag = step(cs)
        state = model(state)
        ref.append((host(cs), host(diag)))
        out.append((to_numpy(state), {k: v.numpy() for k, v in model.last_diag.items()}))
    return ref, out


def test_initial_counters_are_zero():
    model, state = build(8, 8, 3, n_part=8, cap=16, device="cpu")
    assert state.removals is None
    cfg = dataclasses.replace(model.cfg, partmc=dataclasses.replace(
        model.cfg.partmc, record_removals=True))
    from wrf_partmc_tpu_torch.models.coupled.driver import init_coupled
    cs = init_coupled(cfg, model.grid, model.aero_data, model.gas_data, state.dyn)
    assert sorted(cs.removals) == sorted(REMOVAL_CAUSES)
    assert all(v.shape == (3, 8, 8) and not v.any() for v in cs.removals.values())


@pytest.mark.parametrize("cause", REMOVAL_CAUSES)
def test_removal_counters(runs, cause):
    ref, out = runs
    for i in range(1, N_STEPS + 1):
        r, o = ref[i][0].removals[cause], out[i][0].removals[cause]
        floor = 1e-5 * max(ref[j][0].aero.num.sum(-1).max() for j in (i - 1, i))
        assert (np.abs(o - r) <= 1e-4 * np.abs(r) + floor).all(), (
            f"{cause} step {i - 1}: max diff {np.abs(o - r).max()}")
        np.testing.assert_allclose(o.sum(), r.sum(), rtol=1e-4)
    final = ref[-1][0].removals[cause]
    if cause == "chem":          # no nucleation or MOSAIC: coagulation is apart
        assert not final.any()
    else:
        assert final.sum() > 0, f"{cause} removed nothing: the case does not exercise it"


def test_coagulation_records(runs):
    ref, out = runs
    (_, rd), (_, td) = ref[1], out[1]
    for k in ("coag_removed_id", "coag_other_id"):
        assert td[k].dtype == np.int32 and td[k].shape == (3, 8, 8, 16)
        np.testing.assert_array_equal(td[k], rd[k])
    n = int((td["coag_removed_id"] >= 0).sum())
    assert n >= 20, n
    assert ((td["coag_removed_id"] >= 0) == (td["coag_other_id"] >= 0)).all()
    # step 1 runs no coagulation: the reference returns only -1, the port none
    assert (ref[2][1]["coag_removed_id"] == -1).all()
    assert "coag_removed_id" not in out[2][1]


def test_transport_counters(runs):
    ref, out = runs
    for (_, rd), (_, td) in zip(ref[1:], out[1:]):
        for k in TRANSPORT_COUNTERS:
            np.testing.assert_allclose(td[k], rd[k], rtol=1e-6)
    assert out[1][1]["movers"] > 0


def test_transport_off_returns_zero_counters():
    model, state = build(8, 8, 3, n_part=8, cap=16, device="cpu")
    cfg = dataclasses.replace(model.cfg, partmc=dataclasses.replace(
        model.cfg.partmc, do_transport=False))
    off = CoupledModel(cfg, model.grid, model.aero_data, model.gas_data, model.scn,
                       model.exch_h, seed=0)
    out = off(state)
    assert sorted(off.last_diag) == sorted(TRANSPORT_COUNTERS)
    for k in TRANSPORT_COUNTERS:
        v = off.last_diag[k]
        assert v.shape == () and v.dtype == torch.float32 and float(v) == 0.0
    assert out.step == 1
