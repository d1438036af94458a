"""The slice end to end: the em_uniform coupled step (chemistry off) of the
port against ``__graft_entry__._build`` at 12x12x4, 16 particles per cell,
capacity 48, on the CPU.

One step is compared tightly: dycore fields (rtol 1e-4 with an absolute
floor of 1e-4 of each field's scale: last-ulp rounding of transcendentals;
w and ph are roundoff-sized in uniform flow and get absolute floors of
1e-5 m/s and 1e-3 m2/s2), and per cell the alive count (exact), the
represented number (rtol 1e-5) and the per-species volume (rtol 1e-4: the
sampled diameters go through erfinv, whose last ulps differ between the
frameworks, and volume goes as the cube).  Three steps are
compared by domain totals of number and of number per weight class
(rtol 1e-3): a uniform draw that lands within an ulp of a probability
computed through exp/log can flip one particle's fate, which moves these
totals by about one particle weight in 10^4.
"""

import concurrent.futures
import jax
import numpy as np
import pytest

import __graft_entry__ as ge
from wrf_partmc_tpu_torch.convert import to_numpy
from wrf_partmc_tpu_torch.entry import build

N_STEPS = 3


@pytest.fixture(scope="module")
def runs():
    fn, cs = ge._build(nx=12, ny=12, nz=4, n_part=16, cap=48, everything_on=True,
                       chem_on=False)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        step = pool.submit(jax.jit(fn).lower(cs).compile)   # beside the port's steps
        model, state = build(12, 12, 4, n_part=16, cap=48, device="cpu")
        port_states = []
        for _ in range(N_STEPS):
            state = model(state)
            port_states.append(to_numpy(state))
        step = step.result()
    jax_states = []
    for _ in range(N_STEPS):
        cs = step(cs)
        jax_states.append(jax.tree.map(np.asarray, cs))
    return jax_states, port_states, model


ATOL = {"w": 1e-5, "ph": 1e-3}


@pytest.mark.parametrize("name", ["u", "v", "w", "theta_p", "p_p", "mu", "ph",
                                  "moist", "chem", "num_conc", "tke"])
def test_one_step_dycore(runs, name):
    j, t, _ = runs
    ref, out = getattr(j[0].dyn, name), getattr(t[0].dyn, name)
    assert out.shape == ref.shape
    atol = max(ATOL.get(name, 0.0), 1e-4 * float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=atol)


def test_one_step_particles_per_cell(runs):
    j, t, _ = runs
    ja, ta = j[0].aero, t[0].aero
    np.testing.assert_array_equal((ta.num > 0).sum(-1), (ja.num > 0).sum(-1))
    np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
    np.testing.assert_allclose(t[0].gas, j[0].gas, rtol=1e-5, atol=1e-6)
    assert t[0].step == int(j[0].step) == 1


def test_multi_step_domain_totals(runs):
    j, t, model = runs
    n_class = model.cfg.n_class
    for js, ts in zip(j, t):
        np.testing.assert_allclose(ts.aero.num.sum(), js.aero.num.sum(), rtol=1e-3)
        for c in range(n_class):
            np.testing.assert_allclose((ts.aero.num * (ts.aero.w_class == c)).sum(),
                                       (js.aero.num * (js.aero.w_class == c)).sum(),
                                       rtol=1e-3, err_msg=f"class {c}")
        assert np.isfinite(ts.dyn.theta_p).all() and np.isfinite(ts.aero.num).all()
    assert t[-1].step == N_STEPS


def test_chem_on_builds_and_steps():
    """``build(chem_on=True)`` (tests/test_torch_chem_coupled.py holds it
    against the JAX package): the chemistry macro-step runs at step 0."""
    model, state = build(chem_on=True, device="cpu")
    out = model(state)
    assert model.mech is not None and model.mech.n_spec == out.gas.shape[-1] == 77
    assert not np.allclose(to_numpy(out).gas, to_numpy(state).gas)
    assert np.isfinite(to_numpy(out).gas).all() and out.step == 1
