"""Initial-condition, boundary-condition and emission input files.

Port of ``wrf_partmc_tpu/tools/make_inputs.py``, the stand-in for the
reference's pre-processing tools (``make_ics.F90`` / ``make_bcs.F90``, read
by ``init_read_in_ics`` / ``_bcs``, and ``emissions/make_emissions.F90``,
read by ``init_read_in_emissions``).  The file contract is the JAX
package's: ONE whole-domain NetCDF per kind holding stacked mode-parameter
arrays, so a file written by either package reads in the other.  Readers
return the port's :class:`AeroDist` (leading cell axes allowed) on
``device``; writers take tensors on any device, or numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.partmc.dist import AeroDist


def _nc(path, mode="w"):
    from scipy.io import netcdf_file
    return netcdf_file(path, mode, version=2)


def _np(a, dtype=np.float32):
    """A tensor (any device) or array-like as a numpy array of ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _write_dist(f, prefix: str, dist: AeroDist, dims: tuple):
    """Write a (possibly cell-batched) AeroDist's arrays under ``prefix``;
    source and w_class are per mode only."""
    def var(name, var_dims, data, typ="f"):
        f.createVariable(prefix + name, typ, var_dims)[:] = _np(
            data, np.float32 if typ == "f" else np.int32)

    var("num_conc", dims + ("mode",), dist.num_conc)
    var("geom_mean_diam", dims + ("mode",), dist.geom_mean_diam)
    var("log_geom_std", dims + ("mode",), dist.log_geom_std)
    var("vol_frac", dims + ("mode", "spec"), dist.vol_frac)
    var("source", ("mode",), dist.source, "i")
    var("w_class", ("mode",), dist.w_class, "i")


def _tensor(v, dtype, device):
    return torch.as_tensor(np.array(v[:]).astype(dtype), device=device)


def _read_dist(f, prefix: str, device) -> AeroDist:
    g = lambda n: _tensor(f.variables[prefix + n], np.float32, device)
    gi = lambda n: _tensor(f.variables[prefix + n], np.int32, device)
    return AeroDist(num_conc=g("num_conc"), geom_mean_diam=g("geom_mean_diam"),
                    log_geom_std=g("log_geom_std"), vol_frac=g("vol_frac"),
                    source=gi("source"), w_class=gi("w_class"))


def _dims(f, names, sizes):
    for n, s in zip(names, sizes):
        f.createDimension(n, s)


# ------------------------------------------------------------------- ICs

def write_ics(path: str, dist: AeroDist) -> None:
    """Per-level/per-cell IC modes: dist arrays [M], [nz, M] or
    [nz, ny, nx, M] (vol_frac [..., M, S])."""
    f = _nc(path)
    lead = tuple(dist.num_conc.shape[:-1])
    names = ("z", "y", "x")[:len(lead)]
    _dims(f, names, lead)
    _dims(f, ("mode", "spec"), (dist.n_mode, dist.vol_frac.shape[-1]))
    _write_dist(f, "ic_", dist, names)
    f.flush()
    f.close()


def read_ics(path: str, device="cpu") -> AeroDist:
    f = _nc(path, "r")
    d = _read_dist(f, "ic_", device)
    f.close()
    return d


# -------------------------------------------------------------- emissions

def write_emissions(path: str, times, dist: AeroDist, gas_rate) -> None:
    """Emission time series: dist arrays [T, (nz, ny, nx,)? M] with rates
    in [# m-3 s-1]; gas_rate [T, (nz, ny, nx,)? G] ppb s-1."""
    times = _np(times)
    gas_rate = _np(gas_rate)
    f = _nc(path)
    lead = tuple(dist.num_conc.shape[1:-1])
    names = ("z", "y", "x")[:len(lead)]
    f.createDimension("time", len(times))
    _dims(f, names, lead)
    _dims(f, ("mode", "spec", "gas"), (dist.n_mode, dist.vol_frac.shape[-1],
                                       gas_rate.shape[-1]))
    f.createVariable("time", "f", ("time",))[:] = times
    _write_dist(f, "emit_", dist, ("time",) + names)
    f.createVariable("gas_emit_rate", "f", ("time",) + names + ("gas",))[:] = gas_rate
    f.flush()
    f.close()


def read_emissions(path: str, device="cpu"):
    """-> (times [T], AeroDist, gas rate), all on ``device``."""
    f = _nc(path, "r")
    times = _tensor(f.variables["time"], np.float32, device)
    dist = _read_dist(f, "emit_", device)
    gas = _tensor(f.variables["gas_emit_rate"], np.float32, device)
    f.close()
    return times, dist, gas


# -------------------------------------------------------------------- BCs

def write_bcs(path: str, times, back_dist: AeroDist, back_gas,
              dilution_rate) -> None:
    """Lateral-boundary background reservoir time series (the scenario
    background + dilution encoding of ``init_read_in_bcs``): back_dist
    arrays [T, (nz,)? M], back_gas [T, (nz,)? G] ppb, dilution_rate [T]."""
    times = _np(times)
    back_gas = _np(back_gas)
    f = _nc(path)
    lead = tuple(back_dist.num_conc.shape[1:-1])
    names = ("z",)[:len(lead)]
    f.createDimension("time", len(times))
    _dims(f, names, lead)
    _dims(f, ("mode", "spec", "gas"), (back_dist.n_mode, back_dist.vol_frac.shape[-1],
                                       back_gas.shape[-1]))
    f.createVariable("time", "f", ("time",))[:] = times
    _write_dist(f, "bc_", back_dist, ("time",) + names)
    f.createVariable("back_gas", "f", ("time",) + names + ("gas",))[:] = back_gas
    f.createVariable("dilution_rate", "f", ("time",))[:] = _np(dilution_rate)
    f.flush()
    f.close()


def read_bcs(path: str, device="cpu"):
    """-> (times [T], AeroDist, back gas, dilution rate [T]) on ``device``."""
    f = _nc(path, "r")
    g = lambda n: _tensor(f.variables[n], np.float32, device)
    times, dist = g("time"), _read_dist(f, "bc_", device)
    gas, dil = g("back_gas"), g("dilution_rate")
    f.close()
    return times, dist, gas, dil


# ------------------------------------------------------------- wrfinput

def write_wrfinput(path: str, cfg, hgt=None, proj_kind="lambert",
                   cen_lat=40.0, cen_lon=-97.0, truelat1=30.0, truelat2=60.0,
                   stand_lon=-97.0, dtheta_dz=4.0e-3, u_jet=12.0, v0=0.0,
                   rh0=0.5, seed=0, ivgtyp=None, isltyp=None) -> None:
    """A synthetic wrfinput-like NetCDF (the ``real_em`` input contract):
    terrain (the 300 m hill unless ``hgt``), map-projection metadata and a
    stable sheared moist sounding with 0.1 K seeded noise, in wrfinput
    variable names and dimensions, so :func:`models.dycore.real.init_real`
    of either package reads it.  It stands in for WPS."""
    from .. import constants as c
    from ..grid import make_grid
    from ..models.dycore.ideal import hill_terrain
    from ..models.physics.thermo import saturation_vapor_pressure
    from ..utils import llxy

    d = cfg.domain
    if hgt is None:
        hgt = hill_terrain(cfg, h0=300.0, half_width_frac=0.2)
    hgt = np.asarray(hgt)
    grid = make_grid(cfg, hgt=hgt)
    g = lambda t: t.numpy()                     # the grid's float32 fields
    nz, ny, nx = d.nz, d.ny, d.nx

    proj = llxy.make_projection(proj_kind, cen_lat, cen_lon, d.dx, stdlon=stand_lon,
                                truelat1=truelat1, truelat2=truelat2)
    xlat, xlong, msft, f_cor = llxy.grid_geography(proj, nx, ny)

    # stable sounding on the terrain-following half levels
    phb = g(grid.phb)
    z3 = (np.float32(0.5) * (phb[1:] + phb[:-1])) / c.GRAV
    theta = c.T0 + dtheta_dz * z3
    gen = np.random.default_rng(seed)
    theta += 0.1 * gen.standard_normal(theta.shape)
    # sheared zonal jet peaking mid-domain
    ztop = float(g(grid.z_full)[-1])
    u3 = u_jet * np.sin(np.pi * np.clip(z3 / ztop, 0, 1))
    v3 = np.full_like(u3, v0)
    # moisture: fixed RH against the base-state temperature profile
    pb3 = g(grid.pb3)
    t3 = theta * (pb3 / c.P0) ** c.KAPPA
    e_sat = saturation_vapor_pressure(torch.as_tensor(t3.astype(np.float32))).numpy()
    qv = rh0 * c.EPS_VAP * e_sat / np.maximum(pb3 - e_sat, 1e3)
    qv = np.clip(qv, 0.0, 0.02) * np.exp(-z3 / 3000.0)
    # moist surface pressure: base dry + vapor column
    p_top = float(g(grid.p_base)[0] - float(grid.mu_base) * float(g(grid.eta_half)[0]))
    deta = g(grid.deta).reshape(-1, 1, 1)
    psfc = p_top + g(grid.mub) * (1.0 + np.sum(qv * deta, axis=0))

    f = _nc(path)
    for name, n in (("west_east", nx), ("west_east_stag", nx + 1),
                    ("south_north", ny), ("south_north_stag", ny + 1),
                    ("bottom_top", nz), ("bottom_top_stag", nz + 1)):
        f.createDimension(name, n)

    def var(name, dims, data, typ="f"):
        f.createVariable(name, typ, dims)[:] = np.asarray(
            data, np.float32 if typ == "f" else np.int32)

    yx = ("south_north", "west_east")
    var("HGT", yx, hgt)
    # owner-face u is the west-face value; the last face repeats for _stag
    var("U", ("bottom_top", "south_north", "west_east_stag"),
        np.concatenate([u3, u3[..., -1:]], axis=-1))
    var("V", ("bottom_top", "south_north_stag", "west_east"),
        np.concatenate([v3, v3[..., -1:, :]], axis=-2))
    var("T", ("bottom_top",) + yx, theta - c.T0)
    var("QVAPOR", ("bottom_top",) + yx, qv)
    var("PSFC", yx, psfc)
    var("XLAT", yx, xlat)
    var("XLONG", yx, xlong)
    var("MAPFAC_M", yx, msft)
    var("F", yx, f_cor)
    # land-use / soil-texture categories for the Noah LSM (optional)
    if ivgtyp is not None:
        var("IVGTYP", yx, ivgtyp, "i")
    if isltyp is not None:
        var("ISLTYP", yx, isltyp, "i")
    f.DX = float(d.dx)
    f.DY = float(d.dy)
    f.MAP_PROJ = {"lambert": 1, "polar": 2, "mercator": 3, "lat-lon": 6}[proj_kind]
    f.TRUELAT1 = float(truelat1)
    f.TRUELAT2 = float(truelat2)
    f.STAND_LON = float(stand_lon)
    f.CEN_LAT = float(cen_lat)
    f.CEN_LON = float(cen_lon)
    f.P_TOP = p_top
    f.flush()
    f.close()


# --------------------------------------------------------------- wrfbdy

def write_wrfbdy(path: str, bdy) -> None:
    """A :class:`BdyData` time series as the wrfbdy-equivalent NetCDF
    (per-edge boundary slabs and the boundary times)."""
    with _nc(path, "w") as f:
        f.createDimension("Time", bdy.times.shape[0])
        f.createVariable("btime", "f4", ("Time",))[:] = _np(bdy.times)
        for name, edges in bdy.slabs.items():
            for e, arr in edges.items():
                a = _np(arr)
                dims = []
                for d, n in enumerate(a.shape):
                    dn = f"{name}_{e}_d{d}"
                    f.createDimension(dn, n)
                    dims.append(dn)
                f.createVariable(f"{name}_{e}", "f4", tuple(dims))[:] = a


def read_wrfbdy(path: str, device="cpu"):
    """The wrfbdy-equivalent file as a :class:`BdyData` on ``device``."""
    from ..models.coupled.bdy import BdyData

    with _nc(path, "r") as f:
        times = _tensor(f.variables["btime"], np.float32, device)
        slabs = {}
        for vn in f.variables:
            if vn == "btime" or "_" not in vn:
                continue
            name, e = vn.rsplit("_", 1)
            if e not in ("xs", "xe", "ys", "ye"):
                continue
            slabs.setdefault(name, {})[e] = _tensor(f.variables[vn], np.float32, device)
    return BdyData(times=times, slabs=slabs)
