"""Small sample inputs for the runner's file-driven and real-data paths.

Every input is written by the port's own tools: a wrfinput (Lambert
projection, the 300 m hill), per-level two-mode ICs, emissions from a
SMOKE file and an emissions.json of tests/test_make_emissions.py's schema,
BCs from mozbc on a synthetic MOZART file, and a PartMC .spec scenario
shaped like tests/test_spec_file.py's with hourly emission rows.

    from wrf_partmc_tpu_torch.config import namelist_to_config
    from wrf_partmc_tpu_torch.utils.namelist import parse_namelist
    text = real_namelist(12, 12, 4, 16, 48)
    paths = write_real_inputs(d, namelist_to_config(parse_namelist(text)))
    spec = write_spec_scenario(d)

then ``python -m wrf_partmc_tpu_torch.run --namelist <text's file>
--wrfinput ... --ics ... --emissions ... --bcs ...`` (or ``--spec``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import textwrap

import numpy as np
import torch
from scipy.io import netcdf_file

from .. import constants as c
from ..grid import make_grid
from ..models.dycore.real import read_wrfinput
from ..models.partmc.aero_data import make_aero_data
from ..models.partmc.dist import concat_dists, make_mode
from ..models.partmc.gas_data import make_gas_data
from . import make_emissions, make_inputs, mozbc

# the em_uniform runner: 2 km, dt 10 s, live dynamics, emission,
# coagulation, deposition and transport at 40x40x10, 1000 per cell
RUNNER_NAMELIST = """ &time_control
 history_interval = 1,
 restart          = .false.,
 /
 &domains
 e_we   = 41,
 e_sn   = 41,
 e_vert = 11,
 dx     = 2000.0,
 dy     = 2000.0,
 ztop   = 2000.0,
 /
 &dynamics
 chem_adv_opt  = 2,
 moist_adv_opt = 1,
 diff_opt      = 0,
 km_opt        = 4,
 /
 &partmc
 num_particles    = 1000,
 max_particles    = 1280,
 n_emit_slots     = 4,
 partmc_chem_dt   = 60.0,
 do_coagulation   = .true.,
 do_emission      = .true.,
 do_deposition    = .true.,
 do_transport     = .true.,
 do_mosaic        = .false.,
 record_removals  = .true.,
 record_aero_info = .true.,
 /
 &bdy_control
 periodic_x = .true.,
 periodic_y = .true.,
 /
"""

# mozbc's map: gases as VMR (x 1e9 to ppb in run_mozbc), the MOSAIC bins'
# aerosol as kg/kg mass mixing ratios of the synthetic MOZART species
MOZBC_MAP = ["co -> CO", "o3 -> O3", "so2 -> SO2", "oc_a01 -> .02*OC1+.02*OC2+.24*SOA",
             "oc_a02 -> .07*OC1+.07*OC2+.9*SOA", "bc_a01 -> CB1+CB2", "so4_a03 -> .13*SO4"]


def _write_text(path: str, text: str) -> str:
    with open(path, "w") as fh:
        fh.write(textwrap.dedent(text))
    return path


def write_spec_scenario(d: str, z_top_slab: float = 1000.0, hours: int = 24) -> str:
    """A per-height PartMC scenario in ``d``: slabs at z = 0 and
    ``z_top_slab``, each with its own ICs (the remote-continental modes of
    tests/test_spec_file.py, fewer aloft, and a 6-bin sampled mode) and
    gases, and ``hours`` hourly emission rows (SO2, NO2 and a diesel-like
    OC/BC mode, with a diurnal cycle).  Returns the .spec path."""
    _write_text(f"{d}/aero_init_comp.dat", """\
        # composition
        OC               1.375
        SO4              1
        NH4              0.375
        """)
    bins = "diam 1e-8 2e-8 4e-8 8e-8 1.6e-7 3.2e-7 6.4e-7"
    for name, scale in (("aero_init_dist.dat", 1.0), ("aero_init_dist_top.dat", 0.3)):
        _write_text(f"{d}/{name}", f"""\
            mode_name init_small
            mass_frac aero_init_comp.dat
            mode_type log_normal
            num_conc {3.2e9 * scale:.4e}
            geom_mean_diam 2e-8
            log10_geom_std_dev 0.161

            mode_name init_large
            mass_frac aero_init_comp.dat
            mode_type log_normal
            num_conc {2.9e9 * scale:.4e}
            geom_mean_diam 1.16e-7
            log10_geom_std_dev 0.217

            mode_name init_binned
            mass_frac aero_init_comp.dat
            mode_type sampled
            {bins}
            num_conc {" ".join(f"{v * scale:.3e}" for v in (1e8, 3e8, 5e8, 3e8, 1e8, 2e7))}
            """)
    _write_text(f"{d}/gas_init.dat", "NO 0.2\nNO2 1.0\nO3 50.0\nCO 80.0\nSO2 0.8\n")
    _write_text(f"{d}/gas_init_top.dat", "NO 0.02\nNO2 0.3\nO3 70.0\nCO 60.0\n")
    times = [3600.0 * h for h in range(hours)]
    day = [0.5 + 0.5 * math.sin(math.pi * h / 12.0) ** 2 for h in range(hours)]
    row = lambda vals: " ".join(f"{v:.6g}" for v in vals)
    _write_text(f"{d}/gas_emit.dat", f"time {row(times)}\nrate {row([0.5] * hours)}\n"
                f"SO2 {row(4.2e-9 * f for f in day)}\nNO2 {row(1.5e-9 * f for f in day)}\n")
    _write_text(f"{d}/aero_emit_comp.dat", "OC 0.3\nBC 0.7\n")
    _write_text(f"{d}/aero_emit_dist.dat", """\
        mode_name diesel
        mass_frac aero_emit_comp.dat
        mode_type log_normal
        num_conc 1.6e8
        geom_mean_diam 5e-8
        log10_geom_std_dev 0.24
        """)
    _write_text(f"{d}/aero_emit.dat", f"time {row(times)}\nrate {row(day)}\n"
                f"dist {' '.join(['aero_emit_dist.dat'] * hours)}\n")
    return _write_text(f"{d}/test.spec", f"""\
        z                 0.0          {z_top_slab}
        gas_data          gas_data.dat gas_data.dat
        gas_init          gas_init.dat gas_init_top.dat
        aero_data         aero_data.dat aero_data.dat
        aero_init         aero_init_dist.dat aero_init_dist_top.dat
        gas_emission      gas_emit.dat gas_emit.dat
        aero_emission     aero_emit.dat aero_emit.dat
        """)


def write_smoke_inputs(d: str, ny: int, nx: int, hours: int = 3):
    """A SMOKE-like NetCDF [T, ny, nx] (two aerosol sectors in kg m-2 s-1
    over an urban core, and gas_SO2 in mol m-2 s-1) and an emissions.json
    of the reference's schema.  Returns (smoke path, emissions.json path)."""
    y, x = np.meshgrid(np.linspace(-1, 1, ny), np.linspace(-1, 1, nx), indexing="ij")
    core = np.exp(-4.0 * (x * x + y * y))
    day = 0.5 + 0.5 * np.sin(np.pi * np.arange(hours) / 12.0) ** 2
    field = lambda peak: (peak * day[:, None, None] * core[None]).astype(np.float32)
    smoke = os.path.join(d, "smoke.nc")
    with netcdf_file(smoke, "w", version=2) as f:
        f.createDimension("time", hours)
        f.createDimension("y", ny)
        f.createDimension("x", nx)
        f.createVariable("time", "f", ("time",))[:] = np.arange(hours) * 3600.0
        for name, peak in (("traffic", 2.0e-9), ("cooking", 5.0e-10), ("gas_SO2", 2.0e-8)):
            f.createVariable(name, "f", ("time", "y", "x"))[:] = field(peak)
    spec = {"sources": [
        {"source_name": "traffic", "source_class": 2, "weight_class": 2, "modes": [
            {"diameter": 5e-8, "std": 1.7, "fractions": [0.6, 0.2, 0.0]},
            {"diameter": 2e-7, "std": 1.9, "fractions": [0.1, 0.05, 0.05]}]},
        {"source_name": "cooking", "source_class": 1, "weight_class": 1, "modes": [
            {"diameter": 8.6e-8, "std": 1.9, "fractions": [0.9, 0.0, 0.1]}]}]}
    spec_path = os.path.join(d, "emissions.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    return smoke, spec_path


def real_namelist(nx: int, ny: int, nz: int, n_part: int, cap: int) -> str:
    """``RUNNER_NAMELIST`` at nx x ny x nz cells and ``n_part`` particles
    per cell (capacity ``cap``)."""
    text = RUNNER_NAMELIST
    for old, new in (("e_we   = 41", f"e_we   = {nx + 1}"), ("e_sn   = 41", f"e_sn   = {ny + 1}"),
                     ("e_vert = 11", f"e_vert = {nz + 1}"),
                     ("num_particles    = 1000", f"num_particles    = {n_part}"),
                     ("max_particles    = 1280", f"max_particles    = {cap}")):
        if old not in text:
            raise ValueError(f"namelist: {old!r} not found")
        text = text.replace(old, new)
    return text


def write_real_inputs(d: str, cfg) -> dict:
    """The real-data inputs for ``cfg``'s grid, each written by the port's
    tools under ``d``: wrfinput (Lambert, the 300 m hill), per-level
    two-mode ICs, emissions by ``convert_smoke``, BCs by ``run_mozbc`` on
    ``write_synthetic_mozart``.  Returns {flag: path}."""
    os.makedirs(d, exist_ok=True)
    ad, gd = make_aero_data(), make_gas_data()
    nz, ny, nx = cfg.domain.nz, cfg.domain.ny, cfg.domain.nx
    grid = make_grid(cfg)
    paths = {k: os.path.join(d, f"{k}.nc") for k in ("wrfinput", "ics", "emissions", "bcs")}
    make_inputs.write_wrfinput(paths["wrfinput"], cfg)
    vf = np.zeros(ad.n_spec)
    for name, frac in (("SO4", 0.5), ("NH4", 0.2), ("OC", 0.3)):
        vf[ad.spec_by_name(name)] = frac
    ic = concat_dists([make_mode(1.5e9, 4e-8, 1.6, vf), make_mode(6e8, 1.5e-7, 1.7, vf)])
    fall = torch.exp(-grid.z_half / 1500.0)[:, None]         # fewer aloft
    ic = dataclasses.replace(ic, num_conc=ic.num_conc * fall,
                            geom_mean_diam=ic.geom_mean_diam.expand(nz, 2),
                            log_geom_std=ic.log_geom_std.expand(nz, 2),
                            vol_frac=ic.vol_frac.expand(nz, 2, ad.n_spec))
    make_inputs.write_ics(paths["ics"], ic)
    smoke, spec = write_smoke_inputs(d, ny, nx)
    dz0 = float(grid.dz[0])
    n_air = c.P0 / (c.R_D * c.T0) / 0.028964               # mol air m-3
    make_emissions.convert_smoke(
        smoke, spec, ad, ["poc", "pec", "pso4"], paths["emissions"], dz_surface=dz0,
        gas_map={"gas_SO2": (gd.spec_by_name("SO2"), 1e9 / (dz0 * n_air))}, gas_n=gd.n_spec)
    moz = os.path.join(d, "mozart.nc")
    mozbc.write_synthetic_mozart(moz)
    geo = read_wrfinput(paths["wrfinput"])
    mozbc.run_mozbc(moz, MOZBC_MAP, gd, ad, grid, geo["xlat"], geo["xlong"],
                    out_bcs=paths["bcs"])
    return paths
