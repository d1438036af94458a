"""The linear dycore core of the port against the JAX package at 12x12x4.

``_slow_tendencies``, ``_acoustic_integrate``, ``dyn_step`` and
``solve_step`` (``dyn_opt="linear"``: the state has no ``mu``/``ph``) run
on the CPU from one warm-bubble state with moisture and number tracers
made with numpy, Smagorinsky mixing (diff_opt=2) and the Rayleigh damping
of w (damp_opt=1) on, so every term of the core is exercised: advective
tendencies, forward-backward acoustic substeps, the w-p column solve
(``ops/tridiag.solve``: the plain recurrence here, kernel K1 on a card),
RK3 scalar advection with flux capture.  The four JAX functions share one
jit.  Fields are held at rtol 1e-4 with an absolute floor of 1e-4 of
each field's scale (last-ulp rounding of transcendentals and of the
advection limiters), the rule of tests/test_torch_dycore.py.

Then one em_uniform coupled step with ``dyn_opt="linear"`` (chemistry
off, 16 particles per cell) against ``__graft_entry__._build`` with the
same configuration, particle for particle with the tolerances of
tests/test_torch_coupled.py.
"""

import concurrent.futures
import dataclasses

import jax
import numpy as np
import pytest

import __graft_entry__ as ge
import wrf_partmc_tpu.config as jax_config
from wrf_partmc_tpu.config import DomainConfig, uniform_test_config
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.dycore import solve as jsolve
from wrf_partmc_tpu.models.dycore.ideal import init_warm_bubble as jax_init_warm_bubble
from wrf_partmc_tpu_torch import run as prun
from wrf_partmc_tpu_torch.config import PartmcConfig
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.entry import build
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.coupled.driver import CoupledModel
from wrf_partmc_tpu_torch.models.dycore import solve


def _linear_cfg():
    cfg = uniform_test_config().replace(
        domain=DomainConfig(nx=12, ny=12, nz=4, dx=2000.0, dy=2000.0, ztop=2000.0),
        n_class=8)
    return cfg.replace(dynamics=dataclasses.replace(
        cfg.dynamics, dyn_opt="linear", constant_velocity=False, diff_opt=2,
        damp_opt=1, zdamp=1000.0, n_sound=4))


@pytest.fixture(scope="module")
def core():
    cfg = _linear_cfg()
    jgrid = jax_make_grid(cfg)
    s = jax.tree.map(np.asarray, jax_init_warm_bubble(cfg, jgrid))
    assert s.mu is None and s.ph is None
    r = np.random.default_rng(0)
    s = dataclasses.replace(
        s,
        u=(s.u + 5.0 + r.normal(0, 0.5, s.u.shape)).astype(np.float32),
        v=(s.v + 2.0 + r.normal(0, 0.5, s.v.shape)).astype(np.float32),
        p_p=r.normal(0, 5.0, s.p_p.shape).astype(np.float32),
        moist=(s.moist + np.abs(r.normal(0, 1e-3, s.moist.shape))).astype(np.float32),
        num_conc=(s.num_conc + 1e8 * r.uniform(0.5, 1.5, s.num_conc.shape)
                  ).astype(np.float32),
        chem=r.uniform(0.0, 0.05, s.chem.shape).astype(np.float32))

    def jax_all(st):
        tend = jsolve._slow_tendencies(st, jgrid, cfg)
        ac = jsolve._acoustic_integrate(st, tend, st.theta_p, jgrid, cfg,
                                        cfg.dynamics.dt * 0.5, 2)
        return tend, ac, jsolve.dyn_step(st, jgrid, cfg), jsolve.solve_step(st, jgrid, cfg)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jax.jit(jax_all).lower(s).compile)   # beside the port's calls
        pcfg = config_from_reference(cfg)
        grid = make_grid(pcfg)
        ps = from_numpy(s)
        tend = solve._slow_tendencies(ps, grid, pcfg)
        ac = solve._acoustic_integrate(ps, tend, ps.theta_p, grid, pcfg,
                                       pcfg.dynamics.dt * 0.5, 2)
        out = (tend, ac, solve.dyn_step(ps, grid, pcfg), solve.solve_step(ps, grid, pcfg))
        ref = jax.tree.map(np.asarray, ref.result()(s))
    return ref, tuple(to_numpy(o) if not isinstance(o, tuple) else
                      tuple(to_numpy(x) for x in o) for o in out)


def _close(out, ref, what):
    assert out.shape == ref.shape, what
    scale = float(np.abs(ref).max()) + 1e-30
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


@pytest.mark.parametrize("name", ["u", "v", "w", "theta"])
def test_slow_tendencies(core, name):
    ref, out = core
    _close(getattr(out[0], name), getattr(ref[0], name), name)


@pytest.mark.parametrize("i,name", enumerate(["u", "v", "w", "p_p"]))
def test_acoustic_integrate(core, i, name):
    ref, out = core
    _close(out[1][i], ref[1][i], name)


@pytest.mark.parametrize("name", ["u", "v", "w", "theta_p", "p_p"])
def test_dyn_step(core, name):
    ref, out = core
    _close(getattr(out[2], name), getattr(ref[2], name), name)


@pytest.mark.parametrize("name", ["u", "v", "w", "theta_p", "p_p", "moist", "chem",
                                  "num_conc", "tke"])
def test_solve_step_fields(core, name):
    ref, out = core
    new, jnew = out[3][0], ref[3][0]
    assert new.mu is None and new.ph is None
    _close(getattr(new, name), getattr(jnew, name), name)


def test_solve_step_diag(core):
    ref, out = core
    diag, jdiag = out[3][1], ref[3][1]
    for face in ("xm", "xp", "ym", "yp", "zm", "zp"):
        np.testing.assert_allclose(getattr(diag.probs, face), getattr(jdiag.probs, face),
                                   rtol=1e-4, atol=1e-6, err_msg=face)
    for name in ("rho_u", "rho_v", "rho_w", "xkhh"):
        _close(getattr(diag, name), getattr(jdiag, name), name)


def test_linear_config_is_accepted():
    """``dyn_opt="linear"`` builds through the runner and the entry point:
    the state carries no mu/ph and the model is a plain CoupledModel."""
    cfg = _linear_cfg()
    pcfg = config_from_reference(cfg).replace(
        partmc=PartmcConfig(num_particles=4, max_particles=12, n_emit_slots=2,
                            do_coagulation=False, do_emission=False, do_mosaic=False))
    model, state = prun.build_model(pcfg, "uniform", device="cpu")
    assert isinstance(model, CoupledModel) and state.dyn.mu is None
    out = model(state)
    assert out.dyn.mu is None and bool(np.isfinite(to_numpy(out).dyn.w).all())
    _, st = build(6, 6, 4, n_part=4, cap=12, dyn_opt="linear", device="cpu")
    assert st.dyn.mu is None and st.dyn.ph is None


@pytest.fixture(scope="module")
def coupled():
    def linear_uniform(**kw):
        cfg = uniform_test_config(**kw)
        return cfg.replace(dynamics=dataclasses.replace(cfg.dynamics, dyn_opt="linear"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_config, "uniform_test_config", linear_uniform)
        fn, cs = ge._build(nx=12, ny=12, nz=4, n_part=16, cap=48, everything_on=True,
                           chem_on=False)
    assert cs.dyn.mu is None
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        step = pool.submit(jax.jit(fn).lower(cs).compile)   # beside the port's step
        model, state = build(12, 12, 4, n_part=16, cap=48, dyn_opt="linear", device="cpu")
        assert model.cfg.dynamics.dyn_opt == "linear" and state.dyn.mu is None
        out = to_numpy(model(state))
        jout = jax.tree.map(np.asarray, step.result()(cs))
    return jout, out


ATOL = {"w": 1e-5}


@pytest.mark.parametrize("name", ["u", "v", "w", "theta_p", "p_p", "moist", "chem",
                                  "num_conc", "tke"])
def test_coupled_step_dycore(coupled, name):
    j, t = coupled
    ref, out = getattr(j.dyn, name), getattr(t.dyn, name)
    assert out.shape == ref.shape
    atol = max(ATOL.get(name, 0.0), 1e-4 * float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=atol)


def test_coupled_step_particles_per_cell(coupled):
    j, t = coupled
    ja, ta = j.aero, t.aero
    np.testing.assert_array_equal((ta.num > 0).sum(-1), (ja.num > 0).sum(-1))
    np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
    np.testing.assert_allclose(t.gas, j.gas, rtol=1e-5, atol=1e-6)
    assert t.step == int(j.step) == 1
