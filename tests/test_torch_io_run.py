"""The port's runtime against the JAX package: the namelist parser, the
clock, ``run.build_model``, the history / particle / aero_removed /
restart writers and readers, the quilt pool and the runner itself, at
8x8x3 cells and 8 to 16 particles per cell.

Files are compared by reading both with scipy: the same dimensions,
variables, types and attributes, and values exact, except the
per-particle optics of ``write_particle_netcdf(with_optics=True)``: the
Mie-table lookup rounds ``log10`` in each framework, so the efficiencies
agree to rtol 1e-5 (tests/test_torch_optics.py), and the absorption cross
section, the difference q_ext - q_sca times the area, to 1e-5 of the
extinction cross section.  The JAX
writers are handed the JAX state (numpy leaves) and the port's the same
state converted; the one JAX compile of the file is the JAX writer's
optics.  The initial states of ``build_model`` agree to 2 ulp (the blob's
``exp``, tests/test_torch_ideal.py).  Restarts must return the state bit
for bit.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from wrf_partmc_tpu.config import (DomainConfig, PartmcConfig, TimeControlConfig,
                                   uniform_test_config)
from wrf_partmc_tpu.config import namelist_to_config as jax_namelist_to_config
from wrf_partmc_tpu.models.physics import lsm as jax_lsm
from wrf_partmc_tpu.run import build_model as jax_build_model
from wrf_partmc_tpu.utils import clock as jax_clock
from wrf_partmc_tpu.utils import io as jax_io
from wrf_partmc_tpu.utils.namelist import parse_namelist as jax_parse_namelist
from wrf_partmc_tpu_torch import run as prun
from wrf_partmc_tpu_torch.config import namelist_to_config
from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.models.coupled.driver import make_env
from wrf_partmc_tpu_torch.models.partmc.bin_grid import make_bin_grid
from wrf_partmc_tpu_torch.models.partmc.diagnostics import process
from wrf_partmc_tpu_torch.models.physics.lsm import init_land, init_noah
from wrf_partmc_tpu_torch.utils import io
from wrf_partmc_tpu_torch.utils.clock import Clock
from wrf_partmc_tpu_torch.utils.namelist import load_namelist, parse_namelist
from wrf_partmc_tpu_torch.utils.quilt import QuiltWriter
from wrf_partmc_tpu_torch.utils.timing import SectionTimers, memtrack_mb
from wrf_partmc_tpu_torch.utils.tree import tensor_leaves

NAMELIST = """
 &time_control
 run_hours      = 0,
 history_interval = 10, 10, 10,   ! minutes
 restart        = .false.,
 /
 &domains
 e_we           = 9, 41,
 e_sn           = 9,
 e_vert         = 4,
 dx             = 2000.0,
 dy             = 2000,
 ztop           = 2000.d0,
 /
 &dynamics
 chem_adv_opt   = 2,
 km_opt         = 4,
 diff_opt       = 1,
 khdif          = 5.0
 /
 &partmc
 num_particles  = 8
 max_particles  = 24
 do_coagulation = .true.
 record_removals = .true.
 partmc_specfile = 'test.spec'
 /
 &bdy_control
 periodic_x     = .false.,
 /
"""


def _small_cfg(**partmc):
    """The JAX package's runner contract config (tests/test_io_run.py)."""
    pm = dict(num_particles=8, max_particles=24, do_coagulation=False,
              do_emission=False, do_deposition=False)
    pm.update(partmc)
    return uniform_test_config().replace(
        domain=DomainConfig(nx=8, ny=8, nz=3, dx=2000.0, dy=2000.0),
        partmc=PartmcConfig(**pm),
        time_control=TimeControlConfig(run_seconds=100.0, history_interval_s=50.0,
                                       auxhist2_interval_s=50.0, restart_interval_s=1e9))


def _live_cfg():
    """Everything on, live dynamics, removals and aero_info recorded, a
    restart every 5 steps."""
    cfg = _small_cfg(num_particles=8, max_particles=24, n_emit_slots=4,
                     partmc_chem_dt=20.0, do_coagulation=True, do_emission=True,
                     do_deposition=True, record_removals=True, record_aero_info=True)
    return cfg.replace(
        domain=dataclasses.replace(cfg.domain, ztop=2000.0),
        dynamics=dataclasses.replace(cfg.dynamics, constant_velocity=False),
        time_control=dataclasses.replace(cfg.time_control, restart_interval_s=50.0))


def _nc(path):
    """(dimensions, {name: (dims, typecode, values)}, attributes) of a file."""
    f = netcdf_file(path, "r", mmap=False)
    out = (dict(f.dimensions),
           {k: (v.dimensions, v.typecode(), np.array(v[:]) if v.shape else np.array(v.getValue()))
            for k, v in f.variables.items()},
           dict(f._attributes))
    f.close()
    return out


def _same_nc(a, b, rtol=None, skip=()):
    """Two files with the same schema and values (``rtol``: {variable: tol};
    values of ``skip`` not compared).  Returns both files' variables."""
    (da, va, aa), (db, vb, ab) = _nc(a), _nc(b)
    assert da == db and aa == ab and sorted(va) == sorted(vb)
    for k in va:
        assert va[k][:2] == vb[k][:2], k
        if k in skip:
            continue
        if rtol and k in rtol:
            np.testing.assert_allclose(va[k][2], vb[k][2], rtol=rtol[k], err_msg=k)
        else:
            np.testing.assert_array_equal(va[k][2], vb[k][2], err_msg=k)
    return va, vb


def _states_equal(a, b):
    assert a.step == b.step
    la, lb = tensor_leaves(a, "s"), tensor_leaves(b, "s")
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


# --- namelist, clock, timers -------------------------------------------------

def test_namelist_matches_jax(tmp_path):
    g = parse_namelist(NAMELIST)
    assert g == jax_parse_namelist(NAMELIST)
    assert g["domains"]["e_we__list"] == [9, 41] and g["domains"]["ztop"] == 2000.0
    assert g["partmc"]["record_removals"] is True
    assert namelist_to_config(g) == config_from_reference(jax_namelist_to_config(g))
    p = tmp_path / "namelist.input"
    p.write_text(NAMELIST)
    assert load_namelist(str(p)) == g


def test_clock_alarms_match_jax():
    ours, ref = Clock(dt=10.0, t_stop=200.0), jax_clock.Clock(dt=10.0, t_stop=200.0)
    for c in (ours, ref):
        c.add_alarm("a", 60.0)
        c.add_alarm("b", 25.0, offset_s=5.0)
        c.add_alarm("off", 0.0)
    seq = []
    while not ours.done():
        rings = tuple(ours.ringing(k) for k in ("a", "b", "off"))
        assert rings == tuple(ref.ringing(k) for k in ("a", "b", "off")) and not rings[2]
        seq.append(rings)
        ours.advance()
        ref.advance()
    assert ref.done() and len(seq) == 20 and sum(r[0] for r in seq) == 4


def test_timers_sync_and_memtrack():
    calls = []
    t = SectionTimers(sync=lambda: calls.append(1))
    for _ in range(2):
        with t.section("a"):
            pass
    assert t.counts["a"] == 2 and len(calls) == 2 and "a" in t.report()
    assert memtrack_mb() > 10.0


# --- build_model -------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(prun.CASES))
def test_build_model_matches_jax(case):
    cfg = _small_cfg()
    _, _, _, _, jcs, jexch, _ = jax_build_model(cfg, case)
    model, cs = prun.build_model(config_from_reference(cfg), case, device="cpu")
    ref, out = jax.tree.map(np.asarray, jcs), to_numpy(cs)
    np.testing.assert_array_equal(model.exch_h.numpy(), np.asarray(jexch))
    for name in ("u", "v", "theta_p", "num_conc"):
        np.testing.assert_array_max_ulp(getattr(out.dyn, name), getattr(ref.dyn, name), 2)
    np.testing.assert_array_equal(out.aero.num > 0, ref.aero.num > 0)
    np.testing.assert_allclose(out.aero.num, ref.aero.num, rtol=1e-5)
    np.testing.assert_allclose(out.aero.vol, ref.aero.vol, rtol=1e-5, atol=0.0)
    for name in ("pid", "source", "w_class", "src_id", "next_id", "hyst_leg"):
        np.testing.assert_array_equal(getattr(out.aero, name), getattr(ref.aero, name))
    assert out.step == 0 and int((out.aero.num > 0).sum()) > 0


def test_file_driven_flags_raise():
    cfg = config_from_reference(_small_cfg())
    for flag in prun.FILE_FLAGS:
        with pytest.raises(NotImplementedError, match="init_from_files"):
            prun.build_model(cfg, input_files={flag: "x.nc"}, device="cpu")
        with pytest.raises(NotImplementedError, match="real.py"):
            prun.main([f"--{flag}", "x.nc", "--device", "cpu", "--outdir", "unused"])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prun.build_model(config_from_reference(_small_cfg()))


def test_weno_namelist_refused_at_build(tmp_path):
    p = tmp_path / "namelist.input"
    p.write_text(NAMELIST.replace("chem_adv_opt   = 2", "chem_adv_opt   = 3"))
    with pytest.raises(NotImplementedError, match="WENO"):
        prun.main(["--namelist", str(p), "--device", "cpu", "--outdir", str(tmp_path)])


# --- writers against the JAX writers ------------------------------------------

@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """One JAX state (removals filled from a seed) written by both
    packages' writers."""
    d = tmp_path_factory.mktemp("written")
    cfg = _small_cfg(record_removals=True)
    grid, ad, _, _, jcs, _, _ = jax_build_model(cfg, "rotational")
    r = np.random.default_rng(0)
    host = jax.tree.map(np.asarray, jcs)
    host = dataclasses.replace(host, removals={
        k: r.uniform(0, 1e9, v.shape).astype(np.float32) for k, v in host.removals.items()})
    pcfg = config_from_reference(cfg)
    pgrid, pad, cs = (from_numpy(jax.tree.map(np.asarray, x)) for x in (grid, ad, host))
    env = make_env(cs.dyn, pgrid, pcfg, cs.step)
    diag = process(cs.aero, pad, env, make_bin_grid(20, 1e-9, 1e-5))
    trans = {"movers": 12.0, "overflow_class": 1.0, "overflow_free": 0.0}
    rows = [np.array([[0, 3, 17, 4], [0, 9, 2, 40]]), np.array([[6, 1, 70, 71]])]
    p = lambda name: str(d / name)
    jax_io.write_history(p("j_hist.nc"), host, grid, cfg, to_numpy(diag), trans_diag=trans)
    io.write_history(p("t_hist.nc"), cs, pgrid, pcfg, diag, trans_diag=trans)
    for opt in (False, True):
        jax_io.write_particle_netcdf(p(f"j_part{opt}.nc"), host, ad, grid, with_optics=opt)
        io.write_particle_netcdf(p(f"t_part{opt}.nc"), cs, pad, pgrid, with_optics=opt)
    jax_io.write_aero_removed(p("j_rem.nc"), rows)
    io.write_aero_removed(p("t_rem.nc"), rows)
    jax_io.write_aero_removed(p("j_rem0.nc"), [])
    io.write_aero_removed(p("t_rem0.nc"), [])
    return dict(dir=d, cfg=cfg, grid=grid, ad=ad, host=host, pcfg=pcfg, pgrid=pgrid,
                pad=pad, cs=cs, diag=diag)


def test_history_file_matches_jax(written):
    d = written["dir"]
    _same_nc(d / "t_hist.nc", d / "j_hist.nc")
    _, v, _ = _nc(d / "t_hist.nc")
    assert {"chi", "d_alpha", "d_gamma", "removed_num_coag", "trans_movers"} <= set(v)
    chi = v["chi"][2]
    assert ((chi >= 0) & (chi <= 1)).all()


@pytest.mark.parametrize("optics", [False, True], ids=["plain", "optics"])
def test_particle_file_matches_jax(written, optics):
    d = written["dir"]
    rtol = {k: 1e-5 for k in ("aero_scatter_xsec", "aero_asymmetry",
                              "aero_refract_real", "aero_refract_imag")}
    va, vb = _same_nc(d / f"t_part{optics}.nc", d / f"j_part{optics}.nc", rtol,
                      skip=("aero_absorb_xsec",))
    if optics:
        o, r = va["aero_absorb_xsec"][2], vb["aero_absorb_xsec"][2]
        ext = r + vb["aero_scatter_xsec"][2]
        assert (np.abs(o - r) <= 1e-5 * ext).all() and (r > 0).any()


def test_aero_removed_file_matches_jax(written):
    d = written["dir"]
    _same_nc(d / "t_rem.nc", d / "j_rem.nc")
    _same_nc(d / "t_rem0.nc", d / "j_rem0.nc")
    _, v, a = _nc(d / "t_rem.nc")
    assert int(a["n_events"]) == 3 and v["aero_removed_removed_id"][2].tolist() == [17, 2, 70]


def test_netcdf_restart_across_packages(written, tmp_path):
    w = written
    cs, host = w["cs"], w["host"]
    # the JAX package writes, the port reads
    jax_io.write_restart_netcdf(str(tmp_path / "j.nc"), host, w["ad"], w["grid"])
    _states_equal(io.read_restart_netcdf(str(tmp_path / "j.nc"), cs, w["pad"]), cs)
    # the port writes, the JAX package reads
    io.write_restart_netcdf(str(tmp_path / "t.nc"), cs, w["pad"], w["pgrid"])
    _same_nc(tmp_path / "t.nc.dyn", tmp_path / "j.nc.dyn")
    back = jax.tree.map(np.asarray, jax_io.read_restart_netcdf(str(tmp_path / "t.nc"),
                                                               w["host"], w["ad"]))
    _states_equal(from_numpy(back), cs)


def test_netcdf_restart_land_across_packages(written, tmp_path):
    w = written
    noah = init_noah(8, 8, 290.0, tbot=287.0)
    cs = dataclasses.replace(w["cs"], land=dataclasses.replace(
        noah, t_soil=noah.t_soil + torch.arange(8.0)[None, None, :]))
    io.write_restart_netcdf(str(tmp_path / "t.nc"), cs, w["pad"], w["pgrid"])
    jtmpl = dataclasses.replace(w["host"], land=jax.tree.map(
        np.asarray, jax_lsm.init_noah(8, 8, 280.0, tbot=280.0)))
    back = jax.tree.map(np.asarray, jax_io.read_restart_netcdf(str(tmp_path / "t.nc"), jtmpl,
                                                               w["ad"]))
    _states_equal(from_numpy(back), cs)
    _states_equal(io.read_restart_netcdf(str(tmp_path / "t.nc"), dataclasses.replace(
        cs, land=init_noah(8, 8, 280.0, tbot=280.0)), w["pad"]), cs)
    # a slab-LSM template must not read a Noah file, nor a template without land
    for land in (init_land(8, 8, 290.0), None):
        with pytest.raises(ValueError, match="land_type"):
            io.read_restart_netcdf(str(tmp_path / "t.nc"),
                                   dataclasses.replace(cs, land=land), w["pad"])


@pytest.mark.parametrize("factor", [2.0, 1 / 3], ids=["larger", "smaller"])
def test_netcdf_restart_capacity_change(written, tmp_path, factor):
    from wrf_partmc_tpu_torch.models.partmc.aero_state import zero_state

    w = written
    cs = w["cs"]
    io.write_restart_netcdf(str(tmp_path / "t.nc"), cs, w["pad"], w["pgrid"])
    cap = int(cs.aero.capacity * factor)
    tmpl = dataclasses.replace(cs, aero=zero_state(w["pad"], cap, cell_shape=cs.aero.cell_shape))
    out = io.read_restart_netcdf(str(tmp_path / "t.nc"), tmpl, w["pad"])
    assert out.aero.capacity == cap
    np.testing.assert_allclose(out.aero.total_num().numpy(), cs.aero.total_num().numpy(),
                               rtol=1e-5)
    ref = jax_io.read_restart_netcdf(str(tmp_path / "t.nc"), dataclasses.replace(
        w["host"], aero=dataclasses.replace(w["host"].aero, num=np.zeros(
            (*cs.aero.cell_shape, cap), np.float32))), w["ad"])
    np.testing.assert_array_equal(out.aero.num.numpy(), np.asarray(ref.aero.num))
    np.testing.assert_array_equal(out.aero.pid.numpy(), np.asarray(ref.aero.pid))


# --- npz restart, quilt --------------------------------------------------------

def test_npz_restart_bitwise(tmp_path):
    """5 steps, restart, 5 steps equals 10 steps, bit for bit."""
    model, cs0 = prun.build_model(config_from_reference(_live_cfg()), device="cpu")
    cs = cs0
    for _ in range(5):
        cs = model(cs)
    io.write_restart(str(tmp_path / "r.npz"), cs)
    cs_b = io.read_restart(str(tmp_path / "r.npz"), cs0)
    _states_equal(cs_b, cs)
    for _ in range(5):
        cs = model(cs)
        cs_b = model(cs_b)
    _states_equal(cs_b, cs)
    assert cs.step == 10 and sum(float(v.sum()) for v in cs.removals.values()) > 0


def test_npz_restart_mismatches_raise(tmp_path):
    cfg = config_from_reference(_small_cfg())
    _, cs = prun.build_model(cfg, device="cpu")
    p = str(tmp_path / "r.npz")
    io.write_restart(p, cs)
    _, cs2 = prun.build_model(cfg.replace(domain=dataclasses.replace(cfg.domain, nx=10)),
                              device="cpu")
    with pytest.raises(ValueError, match="shape"):
        io.read_restart(p, cs2)
    with pytest.raises(ValueError, match="land_type"):
        io.read_restart(p, dataclasses.replace(cs, land=init_land(8, 8)))
    jax_io.write_restart(str(tmp_path / "j.npz"), jax_build_model(_small_cfg())[4])
    with pytest.raises(ValueError, match="do not mix"):
        io.read_restart(str(tmp_path / "j.npz"), cs)


def test_quilted_writes_equal_sync(written, tmp_path):
    w = written
    cs = w["cs"]
    for name, fn in (("hist.nc", lambda p, wr: io.write_history(p, cs, w["pgrid"], w["pcfg"],
                                                                w["diag"], writer=wr)),
                     ("part.nc", lambda p, wr: io.write_particle_netcdf(p, cs, w["pad"],
                                                                        w["pgrid"], writer=wr)),
                     ("rst.npz", lambda p, wr: io.write_restart(p, cs, writer=wr))):
        fn(str(tmp_path / f"sync_{name}"), None)
        with QuiltWriter() as q:
            fn(str(tmp_path / f"async_{name}"), q)
        assert (tmp_path / f"sync_{name}").read_bytes() == \
            (tmp_path / f"async_{name}").read_bytes(), name


# --- the runner -----------------------------------------------------------------

def test_runner_writes_the_jax_runner_contract(tmp_path):
    """tests/test_io_run.py::test_runner_with_history_and_outputs, on the port."""
    cfg = config_from_reference(_small_cfg())
    cs, timers = prun.run(cfg, "uniform", str(tmp_path), verbose=False, device="cpu")
    assert cs.step == 10
    hist = sorted(p for p in os.listdir(tmp_path) if p.startswith("wrfout"))
    parts = sorted(p for p in os.listdir(tmp_path) if p.startswith("partmc"))
    assert hist == ["wrfout_000000.nc", "wrfout_000005.nc"]
    assert parts == ["partmc_000000.nc", "partmc_000005.nc"]
    assert os.path.exists(tmp_path / "restart_final.npz")
    assert {"coupled_step", "partmc_process", "history_write"} <= set(timers.totals)
    _, v, _ = _nc(tmp_path / hist[-1])
    assert v["U"][2].shape == (3, 8, 8) and v["NUM_CONC"][2].shape[0] == cfg.n_class
    assert "chi" in v and "trans_movers" in v
    _, v, _ = _nc(tmp_path / parts[-1])
    assert v["aero_num"][2].shape == (3, 8, 8, 24) and "next_id" in v


def test_runner_resumes_bitwise(tmp_path, capsys):
    """10 live steps with a restart at step 5, through the CLI (npz) and
    through ``run`` (NetCDF); each restart resumed for 5 steps through the
    CLI equals the continuous run bit for bit; the aero_removed stream.
    The runs start from an npz restart of ``build_model``'s state with its
    multiplicities scaled by 1e5, so coagulation pairs off particles in
    every chemistry step."""
    cfg = config_from_reference(_live_cfg())
    configure = lambda c: cfg
    _, cs0 = prun.build_model(cfg, device="cpu")
    init = str(tmp_path / "init.npz")
    io.write_restart(init, dataclasses.replace(cs0, aero=dataclasses.replace(
        cs0.aero, num=cs0.aero.num * 1e5)))
    out = tmp_path / "full"
    cs, timers = prun.main(["--device", "cpu", "--outdir", str(out), "--restart", init],
                           configure=configure)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 10 and cs.step == 10
    files = set(os.listdir(out))
    assert {"restart_000005.npz", "restart_final.npz"} <= files
    removed = sorted(f for f in files if f.startswith("aero_removed"))
    assert removed, files
    _, v, a = _nc(out / removed[0])
    assert int(a["n_events"]) > 0 and (v["aero_removed_removed_id"][2] >= 0).any()
    assert timers.counts["restart_write"] == 2
    out_nc = tmp_path / "full_nc"
    cs_nc, _ = prun.run(cfg, "uniform", str(out_nc), restart_path=init, verbose=False,
                        restart_format="netcdf", device="cpu")
    _states_equal(cs_nc, cs)
    assert {"restart_000005.nc", "restart_000005.nc.dyn"} <= set(os.listdir(out_nc))
    for rst in (out / "restart_000005.npz", out_nc / "restart_000005.nc"):
        cs_b, _ = prun.main(["--device", "cpu", "--outdir", str(tmp_path / rst.name),
                             "--restart", str(rst)], configure=configure)
        _states_equal(cs_b, cs)
    final = io.read_restart(str(out / "restart_final.npz"), cs)
    _states_equal(final, cs)
