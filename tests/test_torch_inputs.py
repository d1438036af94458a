"""The port's input readers and tools against the JAX package's on the same
inputs: ``utils/llxy.py``, ``utils/spec_file.py`` and
``tools/{make_inputs,mozbc,make_emissions}.py``, with every file written by
one package read back by the other.

Both sides compute the projections, the spec parsing and mozbc's
interpolation in numpy, so those agree bit for bit; dists built in
float32 (the spec modes, the sampled bins) and the wrfinput sounding (its
moisture goes through float32 exp in each framework) agree to rtol 1e-6.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from wrf_partmc_tpu.config import Config, DomainConfig
from wrf_partmc_tpu.grid import make_grid as jax_make_grid
from wrf_partmc_tpu.models.coupled.bdy import BdyData as JBdyData
from wrf_partmc_tpu.models.partmc import dist as jdist
from wrf_partmc_tpu.models.partmc.aero_data import make_aero_data as jax_make_aero_data
from wrf_partmc_tpu.models.partmc.gas_data import make_gas_data as jax_make_gas_data
from wrf_partmc_tpu.tools import make_emissions as jme
from wrf_partmc_tpu.tools import make_inputs as jmi
from wrf_partmc_tpu.tools import mozbc as jmozbc
from wrf_partmc_tpu.utils import llxy as jllxy
from wrf_partmc_tpu.utils import spec_file as jsf

from wrf_partmc_tpu_torch.convert import config_from_reference, from_numpy, to_numpy
from wrf_partmc_tpu_torch.grid import make_grid
from wrf_partmc_tpu_torch.models.partmc.aero_data import make_aero_data
from wrf_partmc_tpu_torch.models.partmc.gas_data import make_gas_data
from wrf_partmc_tpu_torch.tools import make_emissions, make_inputs, mozbc, sample_inputs
from wrf_partmc_tpu_torch.utils import llxy, spec_file

JAD, JGD = jax_make_aero_data(), jax_make_gas_data()
AD, GD = make_aero_data(), make_gas_data()
CFG = Config(domain=DomainConfig(nx=6, ny=5, nz=8, dx=4000.0, dy=4000.0, ztop=12000.0))


def host(tree):
    return jax.tree.map(np.asarray, tree)


def assert_dist_close(out, ref, rtol=1e-6):
    """Two AeroDists (numpy leaves) field by field, dtypes and shapes equal."""
    for f in dataclasses.fields(ref):
        a, b = np.asarray(getattr(out, f.name)), np.asarray(getattr(ref, f.name))
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=f.name)


def read_vars(path):
    with netcdf_file(path, "r", mmap=False) as f:
        return ({k: np.array(v[:]) for k, v in f.variables.items()},
                {k: v for k, v in f._attributes.items()})


def assert_same_file(path_a, path_b, rtol=0.0):
    va, aa = read_vars(path_a)
    vb, ab = read_vars(path_b)
    assert sorted(va) == sorted(vb) and aa == ab
    for k in va:
        assert va[k].dtype == vb[k].dtype and va[k].shape == vb[k].shape, k
        np.testing.assert_allclose(va[k], vb[k], rtol=rtol, atol=0, err_msg=k)


# ------------------------------------------------------------------ llxy

PROJECTIONS = {
    "lambert": dict(lat1=40.0, lon1=-97.0, dx=12000.0, stdlon=-97.0, truelat1=30.0,
                    truelat2=60.0),
    "lambert_tangent": dict(lat1=40.0, lon1=-97.0, dx=4000.0, stdlon=-100.0,
                            truelat1=45.0),
    "polar": dict(lat1=70.0, lon1=-40.0, dx=20000.0, stdlon=-45.0, truelat1=60.0),
    "polar_south": dict(lat1=-70.0, lon1=10.0, dx=20000.0, stdlon=0.0, truelat1=-60.0),
    "mercator": dict(lat1=10.0, lon1=120.0, dx=9000.0, truelat1=15.0),
    "lat-lon": dict(lat1=-10.0, lon1=170.0, dx=25000.0),
}


@pytest.mark.parametrize("name", sorted(PROJECTIONS))
def test_llxy_matches_jax(name):
    kind = name.split("_")[0] if name != "lat-lon" else name
    kw = PROJECTIONS[name]
    p, jp = llxy.make_projection(kind, **kw), jllxy.make_projection(kind, **kw)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    for a, b in zip(llxy.grid_geography(p, 7, 5), jllxy.grid_geography(jp, 7, 5)):
        np.testing.assert_array_equal(a, b)
    lat, lon = llxy.ij_to_latlon(p, np.array([1.0, 3.5, 7.0]), np.array([1.0, 2.25, 5.0]))
    i, j = llxy.latlon_to_ij(p, lat, lon)
    for a, b in zip((lat, lon, i, j), (*jllxy.ij_to_latlon(jp, [1.0, 3.5, 7.0], [1.0, 2.25, 5.0]),
                                       *jllxy.latlon_to_ij(jp, lat, lon))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(i, [1.0, 3.5, 7.0], atol=1e-6)
    np.testing.assert_array_equal(llxy.map_factor(p, lat), jllxy.map_factor(jp, lat))


# ------------------------------------------------------------ spec_file

@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """tests/test_spec_file.py's scenario with a second slab whose modes
    differ, a sampled (binned) mode and 24 hourly emission rows
    (``tools/sample_inputs.py::write_spec_scenario``)."""
    d = tmp_path_factory.mktemp("spec")
    return sample_inputs.write_spec_scenario(str(d), z_top_slab=3500.0, hours=24), d


def test_spec_aero_dists(scenario):
    spec, d = scenario
    for name in ("aero_init_dist.dat", "aero_init_dist_top.dat", "aero_emit_dist.dat"):
        ref = host(jsf.read_aero_dist_dat(str(d / name), JAD, source=1, w_class=2))
        out = to_numpy(spec_file.read_aero_dist_dat(str(d / name), AD, source=1, w_class=2))
        assert_dist_close(out, ref)
    top = spec_file.read_aero_dist_dat(str(d / "aero_init_dist_top.dat"), AD)
    assert top.n_mode == 2 + 6                      # two log-normal modes and 6 bins


def test_spec_gas_files_and_scenario(scenario):
    spec, d = scenario
    np.testing.assert_array_equal(spec_file.read_gas_init_dat(str(d / "gas_init.dat"), GD),
                                  jsf.read_gas_init_dat(str(d / "gas_init.dat"), JGD))
    for a, b in zip(spec_file.read_gas_emit_dat(str(d / "gas_emit.dat"), GD),
                    jsf.read_gas_emit_dat(str(d / "gas_emit.dat"), JGD)):
        np.testing.assert_array_equal(a, b)
    t, r, dists = spec_file.read_aero_emit_dat(str(d / "aero_emit.dat"), AD)
    jt, jr, jdists = jsf.read_aero_emit_dat(str(d / "aero_emit.dat"), JAD)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(r, jr)
    assert len(dists) == len(jdists) == 24
    for a, b in zip(dists, jdists):
        assert_dist_close(to_numpy(a), host(b))
    s, js = spec_file.load_scenario_spec(spec), jsf.load_scenario_spec(spec)
    assert s.keys() == js.keys()
    for k in s:
        np.testing.assert_array_equal(np.asarray(s[k]), np.asarray(js[k]), err_msg=k)
    assert spec_file.parse_spec_lines("a 1 2 # c\n\n# x\nb 3") == [("a", ["1", "2"]),
                                                                  ("b", ["3"])]


# ----------------------------------------------------------- make_inputs

def _dist(lead, M=2, seed=0, S=20):
    r = np.random.default_rng(seed)
    f = lambda *s: r.uniform(0.5, 1.5, (*lead, *s)).astype(np.float32)
    vf = f(M, S)
    return jdist.AeroDist(num_conc=1e9 * f(M), geom_mean_diam=1e-7 * f(M),
                          log_geom_std=0.4 * f(M), vol_frac=vf / vf.sum(-1, keepdims=True),
                          source=np.arange(M, dtype=np.int32),
                          w_class=np.arange(M, dtype=np.int32)[::-1].copy())


@pytest.mark.parametrize("lead", [(), (8,), (8, 5, 6)])
def test_ics_files_cross_read(tmp_path, lead):
    d = _dist(lead)
    jmi.write_ics(str(tmp_path / "j.nc"), d, None)
    make_inputs.write_ics(str(tmp_path / "t.nc"), from_numpy(d))
    assert_same_file(tmp_path / "j.nc", tmp_path / "t.nc")
    assert_dist_close(to_numpy(make_inputs.read_ics(str(tmp_path / "j.nc"))), d, rtol=0)
    assert_dist_close(host(jmi.read_ics(str(tmp_path / "t.nc"))), d, rtol=0)


@pytest.mark.parametrize("lead", [(), (5, 6)])
def test_emission_and_bc_files_cross_read(tmp_path, lead):
    T, G = 3, GD.n_spec
    r = np.random.default_rng(1)
    times = np.array([0.0, 1800.0, 3600.0])
    d = _dist((T, *lead), M=3)
    gas = r.random((T, *lead, G)).astype(np.float32)
    jmi.write_emissions(str(tmp_path / "je.nc"), times, d, gas)
    make_inputs.write_emissions(str(tmp_path / "te.nc"), times, from_numpy(d), torch.tensor(gas))
    assert_same_file(tmp_path / "je.nc", tmp_path / "te.nc")
    t, dist, g = make_inputs.read_emissions(str(tmp_path / "je.nc"))
    jt, jd, jg = jmi.read_emissions(str(tmp_path / "te.nc"))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert_dist_close(to_numpy(dist), host(jd), rtol=0)

    bd = _dist((T, 8), M=2, seed=3)
    bgas = r.random((T, 8, G)).astype(np.float32)
    dil = np.array([1e-5, 2e-5, 3e-5])
    jmi.write_bcs(str(tmp_path / "jb.nc"), times, bd, bgas, dil)
    make_inputs.write_bcs(str(tmp_path / "tb.nc"), times, from_numpy(bd), bgas, dil)
    assert_same_file(tmp_path / "jb.nc", tmp_path / "tb.nc")
    out = make_inputs.read_bcs(str(tmp_path / "jb.nc"))
    ref = jmi.read_bcs(str(tmp_path / "tb.nc"))
    for a, b in zip((out[0], out[2], out[3]), (ref[0], ref[2], ref[3])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_dist_close(to_numpy(out[1]), host(ref[1]), rtol=0)


@pytest.mark.parametrize("proj", ["lambert", "polar", "mercator", "lat-lon"])
def test_write_wrfinput_matches_jax(tmp_path, proj):
    iv = (np.arange(30, dtype=np.int32).reshape(5, 6) % 24) + 1
    isl = (np.arange(30, dtype=np.int32).reshape(5, 6) % 12) + 1
    kw = dict(proj_kind=proj, cen_lat=45.0 if proj != "polar" else 70.0, seed=3,
              ivgtyp=iv, isltyp=isl)
    jmi.write_wrfinput(str(tmp_path / "j.nc"), CFG, **kw)
    make_inputs.write_wrfinput(str(tmp_path / "t.nc"), config_from_reference(CFG), **kw)
    assert_same_file(tmp_path / "j.nc", tmp_path / "t.nc", rtol=1e-6)
    v, attrs = read_vars(tmp_path / "t.nc")
    assert v["HGT"].max() > 100.0 and (v["QVAPOR"] > 0).all() and attrs["DX"] == 4000.0


def test_wrfbdy_files_cross_read(tmp_path):
    r = np.random.default_rng(2)
    slabs = {name: {e: r.random((2, 3, 4, 5) if e in ("xs", "xe") else (2, 3, 5, 4)
                                ).astype(np.float32) for e in ("xs", "xe", "ys", "ye")}
             for name in ("u", "theta_p", "mu")}
    jb = JBdyData(times=np.array([0.0, 3600.0], np.float32), slabs=slabs)
    jmi.write_wrfbdy(str(tmp_path / "j.nc"), jb)
    make_inputs.write_wrfbdy(str(tmp_path / "t.nc"), from_numpy(jb))
    assert_same_file(tmp_path / "j.nc", tmp_path / "t.nc")
    out = make_inputs.read_wrfbdy(str(tmp_path / "j.nc"))
    np.testing.assert_array_equal(out.times.numpy(), jb.times)
    for name, edges in slabs.items():
        for e, a in edges.items():
            np.testing.assert_array_equal(out.slabs[name][e].numpy(), a)


# ---------------------------------------------------------------- mozbc

SPC_MAP = ["co -> CO", "o3 -> O3", "so2 -> SO2",
           "oc_a01 -> .02*OC1+.02*OC2+.24*SOA;1e9",
           "oc_a02 -> .07*OC1+.07*OC2+.9*SOA;1e9",
           "bc_a01 -> CB1+CB2;.11e9", "so4_a03 -> .13*SO4;3.3e9"]


def test_parse_spc_map_matches_jax():
    entries = SPC_MAP + ["par -> C3H6+3*C3H8+2*BIGENE+5*BIGALK", "tol -> .75*TOLUENE"]
    assert mozbc.parse_spc_map(entries) == jmozbc.parse_spc_map(entries)


def test_mozbc_matches_jax(tmp_path):
    jmozbc.write_synthetic_mozart(str(tmp_path / "jmoz.nc"))
    mozbc.write_synthetic_mozart(str(tmp_path / "moz.nc"))
    assert_same_file(tmp_path / "jmoz.nc", tmp_path / "moz.nc")
    ny, nx = CFG.domain.ny, CFG.domain.nx
    xlat = np.broadcast_to(np.linspace(38.0, 42.0, ny)[:, None], (ny, nx))
    xlong = np.broadcast_to(np.linspace(-100.0, -96.0, nx)[None], (ny, nx))
    ref = jmozbc.run_mozbc(str(tmp_path / "moz.nc"), SPC_MAP, JGD, JAD, jax_make_grid(CFG),
                           xlat, xlong, out_bcs=str(tmp_path / "jb.nc"),
                           out_ics=str(tmp_path / "ji.nc"))
    out = mozbc.run_mozbc(str(tmp_path / "moz.nc"), SPC_MAP, GD, AD,
                          make_grid(config_from_reference(CFG)), xlat, xlong,
                          out_bcs=str(tmp_path / "tb.nc"), out_ics=str(tmp_path / "ti.nc"))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert_same_file(tmp_path / "jb.nc", tmp_path / "tb.nc", rtol=1e-6)
    assert_same_file(tmp_path / "ji.nc", tmp_path / "ti.nc")
    t, dist, gas, dil = make_inputs.read_bcs(str(tmp_path / "jb.nc"))
    assert dist.num_conc.shape == (2, CFG.domain.nz, 8) and float(dist.num_conc.sum()) > 0


# ------------------------------------------------------- make_emissions

def test_convert_smoke_matches_jax(tmp_path):
    """``sample_inputs.write_smoke_inputs``' SMOKE file (two sources, a gas
    field) and emissions.json, converted by both packages."""
    smoke_path, spec_path = sample_inputs.write_smoke_inputs(str(tmp_path), 5, 6, hours=3)
    with open(spec_path) as f:
        assert len(json.load(f)["sources"]) == 2
    kw = dict(smoke_species=["poc", "pec", "pso4"], dz_surface=50.0,
              gas_map={"gas_SO2": (JGD.spec_by_name("SO2"), 1e3)}, gas_n=JGD.n_spec)
    jt, jd, jg = jme.convert_smoke(smoke_path, spec_path, JAD, out_path=str(tmp_path / "j.nc"),
                                   **kw)
    t, d, g = make_emissions.convert_smoke(smoke_path, spec_path, AD,
                                           out_path=str(tmp_path / "t.nc"), **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert_dist_close(to_numpy(d), host(jd), rtol=0)
    assert_same_file(tmp_path / "j.nc", tmp_path / "t.nc")
    assert d.num_conc.shape == (3, 5, 6, 3) and float(g.max()) > 0    # 2 + 1 modes
    assert make_emissions.read_speciation(spec_path) == jme.read_speciation(spec_path)
