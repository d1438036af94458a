"""The real-data on-ramp and the file-driven runner of the port against the
JAX package on the CPU.

- ``dycore/real.py``: ``hydrostatic_rebalance`` and ``init_real`` at 8x8x6
  over the hill, from a wrfinput written by the JAX package's tool;
- ``run.build_model``'s file branches (wrfinput; spec; ics; wrfinput + ics +
  emissions + mozbc BCs) against the JAX ``build_model`` at 6x5x4 with 8
  particles per cell, on the inputs ``tools/sample_inputs.py`` writes (the
  port's tools at the runner's namelist);
- one coupled step from the real-data state (wrfinput, ICs, SMOKE
  emissions, BCs) against the JAX ``coupled_step``, and the BC time-slab
  swap: the step after ``set_scenario`` at a ``bc_times`` boundary uses the
  new background, as the JAX runner's ``scenario_fn(t)`` argument does,
  and the runner's loop swaps there.

Tolerances: the rebalanced state is built in float64 on both sides and
agrees to rtol 1e-5 (its sounding's float32 exp aside, bit for bit);
initial fields to 2 ulp and particles as tests/test_torch_io_run.py holds
``build_model``; the step as tests/test_torch_coupled.py holds it (dycore
rtol 1e-4, w and ph absolute floors 1e-5 m/s and 1e-3 m2/s2; per cell the
alive count exactly, number rtol 1e-5, species volume rtol 1e-4 with a
floor of 1e-6 of the largest; gases rtol 1e-5), but with a floor of 1e-3
of each dycore field's scale, in the way tests/test_torch_options_coupled.py
holds its LES step: over the hill the jet turns a small v and mu', and the
reference's own jitted and eager runs differ by 3.9e-4 of v's scale and
2.7e-4 of mu's in the first step, and by 7.7e-4 of mu's (0.0046 Pa of
6.0) in the second.  The JAX step is compiled once, with the scenario as
an argument, and serves both steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wrf_partmc_tpu import config as jconfig
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.coupled.driver import coupled_step
from wrf_partmc_tpu.models.dycore import real as jreal
from wrf_partmc_tpu.models.dycore.ideal import hill_terrain
from wrf_partmc_tpu.run import build_model as jax_build_model
from wrf_partmc_tpu.tools.make_inputs import write_wrfinput as jax_write_wrfinput
from wrf_partmc_tpu.utils import rng as jrng

from wrf_partmc_tpu_torch import constants as c
from wrf_partmc_tpu_torch import run as prun
from wrf_partmc_tpu_torch.config import namelist_to_config
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.dycore import real
from wrf_partmc_tpu_torch.models.partmc.aero_data import make_aero_data
from wrf_partmc_tpu_torch.models.partmc.dist import make_mode
from wrf_partmc_tpu_torch.models.partmc.gas_data import make_gas_data
from wrf_partmc_tpu_torch.tools import make_inputs, sample_inputs
from wrf_partmc_tpu_torch.utils.namelist import parse_namelist
from wrf_partmc_tpu_torch.utils.tree import tensor_leaves

NX, NY, NZ, N_PART, CAP = 6, 5, 4, 8, 32
DYN_FIELDS = ("u", "v", "w", "theta_p", "p_p", "mu", "ph", "moist", "chem", "num_conc", "tke")
BRANCHES = {"wrfinput": ("wrfinput",), "spec": ("spec",), "ics": ("ics",),
            "real": ("wrfinput", "ics", "emissions", "bcs")}
O3_BACK, DIL_SWAP = 100.0, 1e-3


def host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The runner's config at 6x5x4 and its input files: sample_inputs'
    real-data inputs and .spec scenario, and a BC file whose two time slabs
    (t = 0 and t = 10 s, one step apart) differ: no background and no
    dilution, then 100 ppb O3 mixed in at 1e-3 s-1."""
    d = tmp_path_factory.mktemp("real")
    cfg = namelist_to_config(parse_namelist(sample_inputs.real_namelist(NX, NY, NZ, N_PART, CAP)))
    paths = sample_inputs.write_real_inputs(str(d), cfg)
    paths["spec"] = sample_inputs.write_spec_scenario(str(d), z_top_slab=1000.0, hours=3)
    ad, gd = make_aero_data(), make_gas_data()
    vf = np.zeros(ad.n_spec)
    vf[ad.spec_by_name("SO4")] = 1.0
    back = make_mode(1e9, 1e-7, 1.6, vf)
    back = dataclasses.replace(back, **{f: torch.stack([getattr(back, f) * 0, getattr(back, f)])
                                        for f in ("num_conc", "geom_mean_diam", "log_geom_std",
                                                  "vol_frac")})
    gas = np.zeros((2, gd.n_spec), np.float32)
    gas[1, gd.spec_by_name("O3")] = O3_BACK
    paths["bcs_swap"] = str(d / "bcs_swap.nc")
    make_inputs.write_bcs(paths["bcs_swap"], [0.0, cfg.dynamics.dt], back, gas,
                          [0.0, DIL_SWAP])
    return cfg, paths


def _files(paths, branch):
    return {k: paths[k] for k in BRANCHES[branch]}


def _both(cfg, files):
    jcfg = config_from_reference(cfg, jconfig.Config)
    ref = jax_build_model(jcfg, "uniform", 0, input_files=files)
    model, cs = prun.build_model(cfg, "uniform", 0, input_files=files, device="cpu")
    return jcfg, ref, model, cs


def assert_initial_equal(out, ref):
    for name in DYN_FIELDS:
        np.testing.assert_array_max_ulp(getattr(out.dyn, name), getattr(ref.dyn, name), 2)
    np.testing.assert_array_equal(out.aero.num > 0, ref.aero.num > 0)
    np.testing.assert_allclose(out.aero.num, ref.aero.num, rtol=1e-5)
    np.testing.assert_allclose(out.aero.vol, ref.aero.vol, rtol=1e-5, atol=0.0)
    for name in ("pid", "source", "w_class", "src_id", "next_id", "hyst_leg"):
        np.testing.assert_array_equal(getattr(out.aero, name), getattr(ref.aero, name))
    np.testing.assert_array_equal(out.gas, ref.gas)


def assert_scenario_close(out, ref):
    leaves = {k: t.numpy() for k, t in tensor_leaves(out, "s").items()}
    ref_leaves = {k: np.asarray(v) for k, v in tensor_leaves(from_numpy(host(ref)), "s").items()}
    assert leaves.keys() == ref_leaves.keys()
    for k, a in leaves.items():
        b = ref_leaves[k]
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_build_model_file_branch_matches_jax(inputs, branch):
    cfg, paths = inputs
    _, (grid, _, _, scn, jcs, jexch, scenario_fn), model, cs = _both(cfg, _files(paths, branch))
    assert (scenario_fn is None) == (model.scenario_fn is None) == (branch == "wrfinput")
    assert_initial_equal(to_numpy(cs), host(jcs))
    assert_scenario_close(model.scn, scn)
    np.testing.assert_array_equal(model.exch_h.numpy(), np.asarray(jexch))
    for name in ("hgt", "msft", "f_cor", "mub", "phb"):
        np.testing.assert_array_equal(getattr(model.grid, name).numpy(),
                                      np.asarray(getattr(grid, name)), err_msg=name)
    assert int((cs.aero.num > 0).sum()) > 0 and cs.step == 0
    if branch == "spec":
        # the per-height slabs land on their levels: O3 50 ppb below 1 km, 70 above
        o3 = cs.gas[..., make_gas_data().spec_by_name("O3")]
        low = model.grid.z_half < 1000.0
        assert bool((o3[low] == 50.0).all()) and bool((o3[~low] == 70.0).all())


def test_hydrostatic_rebalance_matches_jax():
    jcfg = jconfig.Config(domain=jconfig.DomainConfig(nx=8, ny=8, nz=6, dx=4000.0, dy=4000.0,
                                                      ztop=12000.0))
    cfg = config_from_reference(jcfg)
    hgt = hill_terrain(jcfg, h0=400.0)
    jgrid, grid = jax_make_grid(jcfg, hgt=hgt), make_grid(cfg, hgt=hgt)
    z3 = np.asarray(0.5 * (jgrid.phb[1:] + jgrid.phb[:-1])) / c.GRAV
    theta_p = 4.0e-3 * z3
    qv = 0.008 * np.exp(-z3 / 3000.0)
    mu_p = 50.0 * np.cos(np.linspace(0, 3, 64)).reshape(8, 8)
    ref = np.asarray(jreal.hydrostatic_rebalance(theta_p, qv, mu_p, jgrid))
    out = real.hydrostatic_rebalance(theta_p, qv, mu_p, grid).numpy()
    assert out.dtype == ref.dtype == np.float32 and out.shape == (7, 8, 8)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    assert np.abs(ref).max() > 1.0


def test_init_real_matches_jax(tmp_path):
    """``init_real`` at 8x8x6 from a wrfinput the JAX package writes: the
    grid (terrain, map factors, Coriolis) and every dycore field."""
    jcfg = jconfig.Config(domain=jconfig.DomainConfig(nx=8, ny=8, nz=6, dx=4000.0, dy=4000.0,
                                                      ztop=12000.0))
    path = str(tmp_path / "wrfinput.nc")
    jax_write_wrfinput(path, jcfg, cen_lat=45.0, seed=2)
    jgrid, jstate, jsfc = jreal.init_real(jcfg, path)
    grid, state, sfc = real.init_real(config_from_reference(jcfg), path)
    for name in ("hgt", "msft", "f_cor", "mub", "phb", "pb3"):
        np.testing.assert_array_equal(getattr(grid, name).numpy(),
                                      np.asarray(getattr(jgrid, name)), err_msg=name)
    ref, out = host(jstate), to_numpy(state)
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        atol = 1e-5 * float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol, err_msg=f.name)
    assert sfc.keys() == jsfc.keys() and np.abs(ref.ph).max() > 1.0
    assert float(ref.theta_p[-1].mean()) > 5.0 and np.isfinite(out.mu).all()


@pytest.fixture(scope="module")
def stepped(inputs):
    """The real-data build with the swap BCs on both sides, one step with
    the t = 0 slab, then a second step from the reference's first with the
    t = dt slab; the JAX step takes the scenario as an argument (one
    compile)."""
    cfg, paths = inputs
    files = dict(_files(paths, "real"), bcs=paths["bcs_swap"])
    jcfg, (grid, ad, gd, scn, jcs, exch, scenario_fn), model, cs = _both(cfg, files)
    key = jrng.base_key(jcfg.partmc.random_seed or 0)
    step = jax.jit(lambda s, sc: coupled_step(s, grid, jcfg, ad, gd, sc, exch, key,
                                              diag_out=True)[0])
    j1 = host(step(jcs, scenario_fn(0.0)))
    t1 = to_numpy(model(cs))
    t_swap = scenario_fn(cfg.dynamics.dt)
    j2 = host(step(jax.tree.map(jnp.asarray, j1), t_swap))
    from_j1 = from_numpy(j1)
    held = to_numpy(model(from_j1))                  # slab 0 still set
    model.set_scenario(model.scenario_fn(cfg.dynamics.dt))
    t2 = to_numpy(model(from_j1))
    return model, (j1, t1), (j2, t2), held, t_swap


def assert_step_close(ref, out):
    for name in DYN_FIELDS:
        a, b = getattr(out.dyn, name), getattr(ref.dyn, name)
        atol = max({"w": 1e-5, "ph": 1e-3}.get(name, 0.0), 1e-3 * float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol, err_msg=name)
    ja, ta = ref.aero, out.aero
    np.testing.assert_array_equal((ta.num > 0).sum(-1), (ja.num > 0).sum(-1))
    np.testing.assert_allclose(ta.num.sum(-1), ja.num.sum(-1), rtol=1e-5)
    sv = lambda a: (a.vol * a.num[..., None, :]).sum(-1)
    np.testing.assert_allclose(sv(ta), sv(ja), rtol=1e-4, atol=1e-6 * sv(ja).max())
    np.testing.assert_allclose(out.gas, ref.gas, rtol=1e-5, atol=1e-6)
    assert out.step == int(ref.step)


def test_one_coupled_step_from_real_state(stepped):
    _, (j1, t1), _, _, _ = stepped
    assert_step_close(j1, t1)
    assert np.isfinite(t1.dyn.w).all() and float(np.abs(t1.dyn.w).max()) < 5.0
    assert float(np.abs(t1.dyn.u).max()) > 1.0        # the wrfinput's jet


def test_scenario_swap_at_bc_time(stepped):
    """After ``set_scenario`` at the second BC time the step mixes in the
    new background (+1-exp(-1e-3 * 10 s) of 100 ppb O3 in every cell, on
    top of the step without it) and equals the JAX step given that
    slab."""
    model, _, (j2, t2), held, t_swap = stepped
    assert_step_close(j2, t2)
    assert_scenario_close(model.scn, t_swap)
    o3 = make_gas_data().spec_by_name("O3")
    gain = t2.gas[..., o3] - held.gas[..., o3]
    want = (1.0 - np.exp(-DIL_SWAP * model.cfg.dynamics.dt)) * O3_BACK
    np.testing.assert_allclose(gain, want, rtol=0.05)


def test_runner_swaps_the_scenario(inputs, tmp_path):
    """``run.run`` sets ``scenario_fn(clock.t)`` before each step: two
    runner steps equal two model steps with the slab swapped between them,
    bit for bit."""
    cfg, paths = inputs
    files = dict(_files(paths, "real"), bcs=paths["bcs_swap"])
    cfg = cfg.replace(time_control=dataclasses.replace(
        cfg.time_control, run_seconds=2 * cfg.dynamics.dt, history_interval_s=1e9,
        auxhist2_interval_s=1e9, restart_interval_s=1e9))
    cs, _ = prun.run(cfg, "uniform", str(tmp_path / "out"), input_files=files, verbose=False,
                     device="cpu")
    model, s = prun.build_model(cfg, "uniform", input_files=files, device="cpu")
    s = model(s)
    model.set_scenario(model.scenario_fn(cfg.dynamics.dt))
    s = model(s)
    a, b = tensor_leaves(cs, "s"), tensor_leaves(s, "s")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert cs.step == 2


def test_main_runs_the_file_flags(inputs, tmp_path):
    """``python -m wrf_partmc_tpu_torch.run`` with --wrfinput --ics
    --emissions --bcs, and with --spec, on the CPU: one step each, files
    written, finite totals."""
    _, paths = inputs
    nml = tmp_path / "namelist.input"
    nml.write_text(sample_inputs.real_namelist(NX, NY, NZ, N_PART, CAP))
    for flags in (["--wrfinput", paths["wrfinput"], "--ics", paths["ics"], "--emissions",
                   paths["emissions"], "--bcs", paths["bcs"]], ["--spec", paths["spec"]]):
        out = tmp_path / flags[0][2:]
        cs, timers = prun.main(["--namelist", str(nml), "--steps", "1", "--outdir", str(out),
                                "--device", "cpu"] + flags)
        assert cs.step == 1 and timers.counts["coupled_step"] == 1
        assert np.isfinite(float(cs.aero.total_num().sum()))
        assert (out / "restart_final.npz").exists() and (out / "wrfout_000000.nc").exists()
