"""The CARES-shaped coupled step of the port against
``tools/cares_shape.py::build_cares_shape`` at 12x10x8 cells, 16
particles per cell, capacity 32, chemistry on: MYJ,
Morrison with graupel, Grell, correlated-k radiation with the aerosol
optics, the Noah LSM, open boundaries with the steady wrfbdy, and CBM-Z +
MOSAIC with the aerosol-attenuated photolysis (step 0 runs chemistry).

One step is compared tightly, as ``tests/test_torch_chem_coupled.py`` does:
dycore fields rtol 1e-4 with an absolute floor of 1e-4 of each field's
scale (w and ph roundoff-sized); per cell the alive mask slot for slot, the
represented number rtol 1e-5 and the per-species volume rtol 1e-4 with a
floor of 1e-6 of the largest; gases rtol 1e-4 with a 1e-9 ppb floor; the
Noah skin and soil temperatures, soil moisture and the MYJ q2 rtol 1e-5.
Three steps are compared by domain totals of number, of number per weight
class and of dry mass (rtol 1e-3, one particle weight in 10^4, as the
other coupled tests) and of the gases (rtol 1e-4).
"""

import concurrent.futures
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from wrf_partmc_tpu_torch import run as prun
from wrf_partmc_tpu_torch.cares import build_cares_shape
from wrf_partmc_tpu_torch.config import (DomainConfig, PartmcConfig, uniform_test_config,
                                         validate_config)
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.coupled.driver import CoupledModel
from wrf_partmc_tpu_torch.utils.tree import tensor_leaves

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from cares_shape import build_cares_shape as jax_build_cares_shape  # noqa: E402

N_STEPS = 3
SHAPE = dict(nx=12, ny=10, nz=8, n_part=16, cap=32, chem_on=True)


@pytest.fixture(scope="module")
def runs():
    fn, cs, cfg, grid = jax_build_cares_shape(**SHAPE)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        step = pool.submit(jax.jit(fn).lower(cs).compile)   # beside the port's steps
        model, state = build_cares_shape(**SHAPE, device="cpu")
        init = (jax.tree.map(np.asarray, cs), to_numpy(state))
        port_states = []
        for _ in range(N_STEPS):
            state = model(state)
            port_states.append(to_numpy(state))
        step = step.result()
    jax_states = []
    for _ in range(N_STEPS):
        cs = step(cs)
        jax_states.append(jax.tree.map(np.asarray, cs))
    return jax_states, port_states, model, init, cfg


def test_same_config_and_initial_state(runs):
    _, _, model, (j0, t0), jcfg = runs
    assert model.cfg == config_from_reference(jcfg)
    d = model.cfg.dynamics
    assert (d.bl_physics, d.ra_physics, d.cu_physics, d.mp_physics,
            d.sf_surface_physics) == (2, 4, 5, 10, 2)
    assert model.cfg.partmc.do_optical and not model.cfg.boundary.periodic_x
    for name in ("u", "v", "w", "theta_p", "p_p", "mu", "ph", "chem", "tke"):
        np.testing.assert_array_equal(getattr(t0.dyn, name), getattr(j0.dyn, name),
                                      err_msg=name)
    np.testing.assert_allclose(t0.dyn.moist, j0.dyn.moist, rtol=1e-6)
    np.testing.assert_array_equal(t0.gas, j0.gas)
    np.testing.assert_array_equal(t0.aero.num, j0.aero.num)
    for f in ("tsk", "t_soil", "smois", "tbot", "ivgtyp", "isltyp"):
        np.testing.assert_array_equal(getattr(t0.land, f), getattr(j0.land, f), err_msg=f)
    np.testing.assert_array_equal(t0.pbl_q2, j0.pbl_q2)


ATOL = {"w": 1e-5, "ph": 1e-3}


@pytest.mark.parametrize("name", ["u", "v", "w", "theta_p", "p_p", "mu", "ph",
                                  "moist", "chem", "num_conc", "tke"])
def test_one_step_dycore(runs, name):
    j, t, _, _, _ = runs
    ref, out = getattr(j[0].dyn, name), getattr(t[0].dyn, name)
    assert out.shape == ref.shape
    atol = max(ATOL.get(name, 0.0), 1e-4 * float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=atol)


def test_one_step_gases(runs):
    j, t, _, (j0, _), _ = runs
    np.testing.assert_allclose(t[0].gas, j[0].gas, rtol=1e-4, atol=1e-9)
    assert np.abs(j[0].gas - j0.gas).max() > 1e-3          # the chemistry ran


def test_one_step_particles_per_cell(runs):
    j, t, _, _, _ = runs
    ja, ta = j[0].aero, t[0].aero
    np.testing.assert_array_equal(ta.num > 0, ja.num > 0)
    np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
    np.testing.assert_array_equal(ta.next_id, ja.next_id)
    assert t[0].step == int(j[0].step) == 1


def test_one_step_land_and_pbl(runs):
    j, t, _, (j0, _), _ = runs
    for f in ("tsk", "t_soil", "smois"):
        np.testing.assert_allclose(getattr(t[0].land, f), getattr(j[0].land, f),
                                   rtol=1e-5, err_msg=f)
    assert np.abs(j[0].land.tsk - j0.land.tsk).max() > 1e-3    # the LSM ran
    np.testing.assert_allclose(t[0].pbl_q2, j[0].pbl_q2, rtol=1e-5, atol=1e-7)
    assert j[0].pbl_q2.max() > 2 * j0.pbl_q2.max()             # MYJ mixed


def test_multi_step_statistics(runs):
    j, t, model, _, _ = runs
    ad = model.aero_data
    dry = np.array([n != "H2O" for n in ad.names])
    dens = ad.density.numpy()
    mass = lambda a: float(((a.vol * a.num[..., None, :]).sum(-1)[..., dry] * dens[dry]).sum())
    for js, ts in zip(j, t):
        np.testing.assert_allclose(ts.aero.num.sum(), js.aero.num.sum(), rtol=1e-3)
        for c in range(model.cfg.n_class):
            np.testing.assert_allclose((ts.aero.num * (ts.aero.w_class == c)).sum(),
                                       (js.aero.num * (js.aero.w_class == c)).sum(),
                                       rtol=1e-3, err_msg=f"class {c}")
        np.testing.assert_allclose(mass(ts.aero), mass(js.aero), rtol=1e-3)
        np.testing.assert_allclose(ts.gas.sum(axis=(0, 1, 2)), js.gas.sum(axis=(0, 1, 2)),
                                   rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(ts.land.tsk, js.land.tsk, rtol=1e-5)
        assert np.isfinite(ts.dyn.theta_p).all() and np.isfinite(ts.gas).all()
    assert t[-1].step == N_STEPS


def test_convert_round_trip(runs):
    """The JAX state (Noah land state, MYJ q2) and wrfbdy reach the port
    unchanged and come back unchanged."""
    _, _, model, (j0, _), _ = runs
    back = to_numpy(from_numpy(j0))

    def same(a, b, path):
        if dataclasses.is_dataclass(b):
            for f in dataclasses.fields(b):
                same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=path)

    same(j0, back, "state")
    assert type(back.land).__name__ == "NoahState" and back.pbl_q2.shape == (9, 10, 12)
    slabs = to_numpy(model.bdy).slabs
    assert slabs["mu"]["xs"].shape == (2, 10, 5) and slabs["chem"]["ye"].shape[1] == 77


def test_open_boundary_run_stays_finite():
    """Chemistry off at 14x12x10 for 20 steps, past step 16, where the
    reference went NaN before its wrfbdy forced mu and ph: fields finite,
    surface-pressure perturbation under 30 hPa, particles alive."""
    model, state = build_cares_shape(14, 12, 10, n_part=10, cap=24, chem_on=False,
                                     device="cpu")
    for _ in range(20):
        state = model(state)
    for name in ("theta_p", "w", "mu", "moist"):
        assert bool(torch.isfinite(getattr(state.dyn, name)).all()), name
    assert float(state.dyn.mu.abs().max()) < 3000.0
    assert float(state.aero.total_num().sum()) > 0.0 and state.step == 20


OPTIONS = {
    "seasalt": dict(partmc=dict(seasalt_param=1)),
    "sfs_opt=1": dict(dynamics=dict(sfs_opt=1)),
    "km_opt=2 with diff_opt=2": dict(dynamics=dict(diff_opt=2, km_opt=2)),
    "WENO": dict(dynamics=dict(h_adv_order="weno5", v_adv_order="weno3")),
    "YSU": dict(dynamics=dict(bl_physics=1)),
    "BMJ": dict(dynamics=dict(cu_physics=2)),
    "Kessler": dict(dynamics=dict(mp_physics=1)),
    "WSM5": dict(dynamics=dict(mp_physics=2), n_moist=5),
}
# options the port refused before it carried them
UNPORTED = {
    "linear core": dict(dynamics=dict(dyn_opt="linear")),
}


def _with(cfg, groups):
    return cfg.replace(**{g: dataclasses.replace(getattr(cfg, g), **kw) if isinstance(kw, dict)
                          else kw for g, kw in groups.items()})


def _build_and_step(groups, case):
    """The runner's em_uniform case at 6x6x4 (live dynamics, emission on, 4
    particles per cell) with the option ``groups``, built on the CPU and
    stepped once to finite fields.  Returns the model."""
    base = uniform_test_config(
        domain=DomainConfig(nx=6, ny=6, nz=4, dx=2000.0, dy=2000.0, ztop=4000.0),
        partmc=PartmcConfig(num_particles=4, max_particles=12, n_emit_slots=2,
                            do_coagulation=False, do_emission=True, do_mosaic=False))
    base = base.replace(dynamics=dataclasses.replace(base.dynamics, constant_velocity=False))
    cfg = validate_config(_with(base, groups))
    model, state = prun.build_model(cfg, "uniform", device="cpu")
    state = model(state)
    assert state.step == 1
    for a in tensor_leaves(state, "state").values():
        if a.is_floating_point():
            assert bool(torch.isfinite(a).all()), case
    return model


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_option_builds_and_steps(case):
    """Each option the port once refused builds and takes one step."""
    _build_and_step(OPTIONS[case], case)


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_check_supported_refuses_unported(case):
    """The port refuses no option now: ``check_supported`` is gone with its
    last refusal, and the linear core builds and steps with no ``mu``."""
    model = _build_and_step(UNPORTED[case], case)
    assert model.cfg.dynamics.dyn_opt == "linear"


def test_check_supported_accepts_cares(runs):
    assert isinstance(runs[2], CoupledModel)
