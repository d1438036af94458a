"""The chem-on coupled step of the port against ``__graft_entry__._build``
(its default, ``chem_on=True``: 77-gas CBM-Z + MOSAIC over the urban
background) at 12x12x4, 16 particles per cell, capacity 48, ``chem_dt``
60 s, so that step 0 runs the chemistry macro-step.

One step is compared tightly, as ``tests/test_torch_coupled.py`` does with
chemistry off: dycore fields rtol 1e-4 with an absolute floor of 1e-4 of
each field's scale (w and ph roundoff-sized in uniform flow); per cell the
alive count exact, represented number rtol 1e-5 and per-species volume rtol
1e-4 with a floor of 1e-6 of the largest; every gas rtol 1e-4 with a 1e-9
ppb floor (the chemistry's own closed forms and the ROS2 GEMMs sum in
another order; measured agreement is ~6e-6).  Three steps are compared by
domain totals of number, of number per weight class (rtol 1e-3, one
particle weight in 10^4, as chemistry-off) and of the gases (rtol 1e-4).
"""

import concurrent.futures
import jax
import numpy as np
import pytest

import __graft_entry__ as ge
from wrf_partmc_tpu_torch.convert import to_numpy
from wrf_partmc_tpu_torch.entry import GAS_BACKGROUND, build
from wrf_partmc_tpu_torch.models.partmc.cbmz import CBMZ_GASES

N_STEPS = 3


@pytest.fixture(scope="module")
def runs():
    fn, cs = ge._build(nx=12, ny=12, nz=4, n_part=16, cap=48, everything_on=True,
                       chem_on=True, chem_dt=60.0)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        step = pool.submit(jax.jit(fn).lower(cs).compile)   # beside the port's steps
        model, state = build(12, 12, 4, n_part=16, cap=48, chem_on=True, chem_dt=60.0,
                             device="cpu")
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
    return jax_states, port_states, model, init


def test_same_initial_state(runs):
    _, _, model, (j0, t0) = runs
    assert model.cfg.partmc.do_mosaic and model.cfg.n_chem_gas == 77
    assert model.gas_data.names == tuple(n for n, _ in CBMZ_GASES)
    np.testing.assert_array_equal(t0.gas, j0.gas)
    assert set(GAS_BACKGROUND) <= set(model.gas_data.names)
    np.testing.assert_array_equal(t0.aero.num, j0.aero.num)


ATOL = {"w": 1e-5, "ph": 1e-3}


@pytest.mark.parametrize("name", ["u", "v", "w", "theta_p", "p_p", "mu", "ph",
                                  "moist", "chem", "num_conc", "tke"])
def test_one_step_dycore(runs, name):
    j, t, _, _ = runs
    ref, out = getattr(j[0].dyn, name), getattr(t[0].dyn, name)
    assert out.shape == ref.shape
    atol = max(ATOL.get(name, 0.0), 1e-4 * float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=atol)


def test_one_step_gases(runs):
    j, t, model, (j0, _) = runs
    np.testing.assert_allclose(t[0].gas, j[0].gas, rtol=1e-4, atol=1e-9)
    names = model.gas_data.names
    moved = np.abs(j[0].gas - j0.gas).max(axis=(0, 1, 2)) > 1e-6
    for name in ("O3", "NO2", "NO", "OH", "HO2", "HNO3", "H2SO4", "HCHO", "SO2"):
        assert moved[names.index(name)], name          # the chemistry ran


def test_one_step_particles_per_cell(runs):
    j, t, _, (j0, _) = runs
    ja, ta = j[0].aero, t[0].aero
    np.testing.assert_array_equal((ta.num > 0).sum(-1), (ja.num > 0).sum(-1))
    np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
    np.testing.assert_array_equal(np.where(ta.num > 0, ta.hyst_leg, 0),
                                  np.where(ja.num > 0, ja.hyst_leg, 0))
    # MOSAIC moved mass onto the particles: sulfate grew and ammonium formed
    assert sv(ja)[..., 3].sum() > 0 and sv(ja)[..., 0].sum() > sv(j0.aero)[..., 0].sum()
    assert t[0].step == int(j[0].step) == 1


def test_multi_step_domain_totals(runs):
    j, t, model, _ = runs
    n_class = model.cfg.n_class
    for js, ts in zip(j, t):
        np.testing.assert_allclose(ts.aero.num.sum(), js.aero.num.sum(), rtol=1e-3)
        for c in range(n_class):
            np.testing.assert_allclose((ts.aero.num * (ts.aero.w_class == c)).sum(),
                                       (js.aero.num * (js.aero.w_class == c)).sum(),
                                       rtol=1e-3, err_msg=f"class {c}")
        np.testing.assert_allclose(ts.gas.sum(axis=(0, 1, 2)), js.gas.sum(axis=(0, 1, 2)),
                                   rtol=1e-4, atol=1e-9)
        assert np.isfinite(ts.gas).all() and np.isfinite(ts.aero.vol).all()
    assert t[-1].step == N_STEPS
