"""mozbc: global-model chemistry -> IC/BC files for this model.

Port of ``wrf_partmc_tpu/tools/mozbc.py``, the clean-room MOZART-to-WRF-Chem
boundary tool (``mozart_to_wrf/main_bc_wrfchem.f90`` +
``mo_mozart_lib.f90``):

* ``spc_map`` expressions in the dialect of the ``.inp`` control files
  (``mozart_to_wrf/CBMZ.inp``): ``'wrf -> .75*TOL + 3*C3H8 ; 1e9'``, a
  linear combination of global-model variables with an optional
  post-scale after ``;``;
* bilinear horizontal interpolation from the global (lat, lon) grid onto
  the domain's xlat/xlong, and linear-in-log-pressure vertical
  interpolation from hybrid sigma-pressure levels (hyam/hybm/P0 + PS) onto
  the model's base-state pressures;
* gas species land in the per-level background-gas series of the
  lateral-BC contract (``make_inputs.write_bcs``); binned aerosol targets
  (``*_a01..a08``) become a sampled (histogram) size distribution per time
  on the MOSAIC 8-bin sections.

Host-side tool: numpy and scipy NetCDF; the dists it writes are the port's.
"""

from __future__ import annotations

import re

import numpy as np

# MOSAIC 8-bin sectional edges [m] (0.039-10 um, log-spaced), the bin set
# behind the reference's *_a01..a08 map targets
MOSAIC_8BIN_EDGES = 1e-6 * np.logspace(np.log10(0.0390625), np.log10(10.0), 9)

_TERM = re.compile(r"\s*(?:([0-9.eE+-]+)\s*\*\s*)?([A-Za-z_][A-Za-z0-9_]*)")


def parse_spc_map(entries):
    """['wrf -> .5*A+B ; 1e9', ...] -> [(wrf, [(coef, var), ...], scale)]."""
    out = []
    for e in entries:
        lhs, rhs = e.split("->")
        if ";" in rhs:
            rhs, scale = rhs.split(";")
            scale = float(scale)
        else:
            scale = 1.0
        terms = []
        for part in rhs.split("+"):
            m = _TERM.match(part)
            if not m:
                raise ValueError(f"bad spc_map term {part!r} in {e!r}")
            coef = float(m.group(1)) if m.group(1) else 1.0
            terms.append((coef, m.group(2)))
        out.append((lhs.strip(), terms, scale))
    return out


def read_global_model(path: str) -> dict:
    """MOZART-style NetCDF -> {lon, lat, time, p [T,L,lat,lon], species...}.
    Pressure from the hybrid coordinate: p = hyam*P0 + hybm*PS."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    g = lambda n: np.array(f.variables[n][:])
    out = {"lon": g("lon"), "lat": g("lat"), "time": g("time")}
    if "P0" in f.variables:
        p0 = float(np.asarray(f.variables["P0"][:]))
    else:
        p0 = float(getattr(f, "P0", 1.0e5))
    ps = g("PS")                                   # [T, lat, lon]
    hyam, hybm = g("hyam"), g("hybm")              # [L]
    out["p"] = (hyam[None, :, None, None] * p0
                + hybm[None, :, None, None] * ps[:, None])
    out["fields"] = {}
    skip = {"lon", "lat", "time", "PS", "hyam", "hybm", "P0", "lev"}
    for name, v in f.variables.items():
        if name not in skip and v.data.ndim == 4:
            out["fields"][name] = np.array(v[:])
    f.close()
    return out


def _bilinear(field, lat_g, lon_g, lat_t, lon_t):
    """field [..., lat, lon] -> [..., ny, nx] at target lat/lon [ny, nx].

    Longitudes are normalized to a common [0, 360) convention with a wrap
    column appended (the reference's mo_mozart_lib wrap handling), so a
    0-360 global file serves a [-180, 180] domain correctly."""
    lon_g = np.mod(np.asarray(lon_g, float), 360.0)
    lon_t = np.mod(np.asarray(lon_t, float), 360.0)
    order = np.argsort(lon_g)
    lon_g = lon_g[order]
    field = np.asarray(field)[..., order]
    # wrap column for interpolation across the 0/360 seam
    lon_g = np.concatenate([lon_g, lon_g[:1] + 360.0])
    field = np.concatenate([field, field[..., :1]], axis=-1)
    if (np.asarray(lat_t).min() < np.asarray(lat_g).min() - 2.0
            or np.asarray(lat_t).max() > np.asarray(lat_g).max() + 2.0):
        import warnings

        warnings.warn("mozbc: target latitudes extend beyond the global "
                      "model grid; edge values will be clamped")
    fi = np.interp(lon_t, lon_g, np.arange(len(lon_g)))
    fj = np.interp(lat_t, lat_g, np.arange(len(lat_g)))
    i0 = np.clip(np.floor(fi).astype(int), 0, len(lon_g) - 2)
    j0 = np.clip(np.floor(fj).astype(int), 0, len(lat_g) - 2)
    wi = np.clip(fi - i0, 0.0, 1.0)
    wj = np.clip(fj - j0, 0.0, 1.0)
    f00 = field[..., j0, i0]
    f01 = field[..., j0, i0 + 1]
    f10 = field[..., j0 + 1, i0]
    f11 = field[..., j0 + 1, i0 + 1]
    return ((1 - wj) * ((1 - wi) * f00 + wi * f01)
            + wj * ((1 - wi) * f10 + wi * f11))


def _vert_interp(vals, p_src, p_tgt):
    """vals [T, L, ny, nx] on pressures p_src [T, L, ny, nx] -> [T, nz, ...]
    at target pressures p_tgt [nz] (linear in log p, clamped)."""
    T, L = vals.shape[:2]
    ny, nx = vals.shape[2:]
    out = np.empty((T, len(p_tgt)) + (ny, nx))
    lp_t = np.log(p_tgt)
    for t in range(T):
        for j in range(ny):
            for i in range(nx):
                lp = np.log(p_src[t, :, j, i])
                order = np.argsort(lp)
                out[t, :, j, i] = np.interp(lp_t, lp[order],
                                            vals[t, order, j, i])
    return out


_BINNED = re.compile(r"^(.*)_a(\d\d)$")


def run_mozbc(global_path: str, spc_map, gas_data, aero_data, grid,
              xlat, xlong, out_bcs: str | None = None,
              out_ics: str | None = None, dilution_rate=1e-5,
              aero_species_alias=None):
    """The mozbc main loop: map + interpolate, then write this framework's
    BC/IC contracts.

    Returns (times, back_gas [T, nz, G] ppb, binned_aero [T, B] #/m3-proxy
    per bin or None).  ``aero_species_alias`` maps map-target stems (e.g.
    'oc') to aero species names ('OC')."""
    moz = read_global_model(global_path)
    mapping = parse_spc_map(spc_map)
    p_tgt = grid.p_base.cpu().numpy()
    nz = len(p_tgt)
    T = len(moz["time"])

    def mapped(terms, scale):
        acc = None
        for coef, var in terms:
            if var not in moz["fields"]:
                continue
            v = coef * moz["fields"][var]
            acc = v if acc is None else acc + v
        if acc is None:
            return None
        h = _bilinear(acc, moz["lat"], moz["lon"], xlat, xlong)
        p_h = _bilinear(moz["p"], moz["lat"], moz["lon"], xlat, xlong)
        return _vert_interp(h, p_h, p_tgt) * scale     # [T, nz, ny, nx]

    ny, nx = np.asarray(xlat).shape
    back_gas = np.zeros((T, nz, gas_data.n_spec))
    bin_mass = {}                                      # stem -> [B] -> arr
    for wrf_name, terms, scale in mapping:
        mb = _BINNED.match(wrf_name)
        vals = mapped(terms, scale)
        if vals is None:
            continue
        if mb:
            stem, ibin = mb.group(1), int(mb.group(2)) - 1
            bin_mass.setdefault(stem, {})[ibin] = vals
        elif wrf_name.upper() in [n.upper() for n in gas_data.names]:
            gi = [n.upper() for n in gas_data.names].index(wrf_name.upper())
            # MOZART VMR (mol/mol) -> ppb, domain-mean per level for the
            # background reservoir
            back_gas[:, :, gi] = vals.mean(axis=(-2, -1)) * 1e9

    times = np.asarray(moz["time"], float)
    binned = None
    aero_dists = None
    if bin_mass:
        alias = aero_species_alias or {"oc": "OC", "bc": "BC", "so4": "SO4",
                                       "no3": "NO3", "nh4": "NH4",
                                       "na": "Na", "cl": "Cl", "oin": "OIN"}
        B = len(MOSAIC_8BIN_EDGES) - 1
        # mass mixing ratio [kg/kg dry air] -> mass concentration
        # [kg m-3] with the hydrostatic air density of each target level
        # (reference mozbc converts mixing ratio -> concentration ->
        # sectional number; ADVICE r2 medium)
        t_of_p = 288.0 * (p_tgt / 1.0e5) ** 0.19       # standard-atm T(p)
        rho_air = p_tgt / (287.0 * t_of_p)             # [nz]
        edges = np.asarray(MOSAIC_8BIN_EDGES)
        d_center = np.sqrt(edges[:-1] * edges[1:])
        v_mean = np.pi / 6.0 * d_center ** 3           # [B] mean particle vol
        # per-(time, bin, species) mean mass concentration over the domain
        mass_tbs = np.zeros((T, B, aero_data.n_spec))
        for stem, bins in bin_mass.items():
            sp = alias.get(stem.lower())
            if sp is None or sp not in aero_data.names:
                continue
            si = aero_data.names.index(sp)
            for ibin, vals in bins.items():
                conc = vals * rho_air.reshape(1, -1, 1, 1)   # [T,nz,ny,nx]
                mass_tbs[:, ibin, si] += conc.mean(axis=(1, 2, 3))
        # species volume concentration -> per-bin number & volume fractions
        dens = aero_data.density.cpu().numpy()         # [S] kg m-3
        volc_tbs = mass_tbs / dens.reshape(1, 1, -1)   # [T, B, S] m3/m3
        binned = volc_tbs.sum(-1) / v_mean.reshape(1, -1)    # [T, B] #/m3
        vol_frac = volc_tbs.mean(axis=0)               # [B, S]
        from ..models.partmc.dist import from_sampled

        vf = np.where(vol_frac.sum(-1, keepdims=True) > 0, vol_frac, 0.0)
        vf[vf.sum(-1) == 0, 0] = 1.0
        vf = vf / vf.sum(-1, keepdims=True)
        aero_dists = [from_sampled(MOSAIC_8BIN_EDGES, binned[t], vf)
                      for t in range(T)]

    if out_bcs is not None:
        from .make_inputs import write_bcs

        if aero_dists is None:
            from ..models.partmc.dist import make_mode

            vf0 = np.zeros(aero_data.n_spec)
            vf0[0] = 1.0
            aero_dists = [make_mode(0.0, 1e-7, 1.6, vf0) for _ in range(T)]
        import dataclasses as _dc

        # [T, nz, ...] arrays (per-level BC reservoir, the write_bcs lead
        # dims shared with back_gas); source/w_class stay mode-only
        bz = lambda f: np.broadcast_to(
            np.stack([getattr(d, f).cpu().numpy() for d in aero_dists])[:, None],
            (T, nz) + tuple(getattr(aero_dists[0], f).shape))
        back_dist = _dc.replace(
            aero_dists[0], num_conc=bz("num_conc"),
            geom_mean_diam=bz("geom_mean_diam"),
            log_geom_std=bz("log_geom_std"), vol_frac=bz("vol_frac"))
        write_bcs(out_bcs, times, back_dist, back_gas,
                  np.full(T, dilution_rate))
    if out_ics is not None:
        from scipy.io import netcdf_file

        f = netcdf_file(out_ics, "w", version=2)
        f.createDimension("z", nz)
        f.createDimension("gas", gas_data.n_spec)
        v = f.createVariable("gas_init", "f", ("z", "gas"))
        v[:] = back_gas[0].astype(np.float32)
        f.flush()
        f.close()
    return times, back_gas, binned


def write_synthetic_mozart(path: str, n_time=2, n_lev=12, n_lat=13,
                           n_lon=17, species=("CO", "O3", "SO2", "OC1",
                                              "OC2", "SOA", "CB1", "CB2",
                                              "SO4"), seed=0):
    """Synthetic MOZART-style file for tests/demos (hybrid levels, PS,
    smooth latitudinally-varying VMR fields)."""
    from scipy.io import netcdf_file

    rng = np.random.default_rng(seed)
    lat = np.linspace(20.0, 60.0, n_lat)
    lon = np.linspace(-130.0, -60.0, n_lon)
    # hybrid coefficients: pure sigma at bottom -> pure pressure at top
    sig = np.linspace(0.99, 0.01, n_lev)
    hybm = sig ** 1.2
    hyam = (sig - hybm) * 1.0 + 0.01 * (1 - sig)
    f = netcdf_file(path, "w", version=2)
    for n, s in (("time", n_time), ("lev", n_lev), ("lat", n_lat),
                 ("lon", n_lon)):
        f.createDimension(n, s)

    def var(name, dims, data):
        v = f.createVariable(name, "f", dims)
        v[:] = np.asarray(data, np.float32)

    var("time", ("time",), np.arange(n_time) * 21600.0)
    var("lat", ("lat",), lat)
    var("lon", ("lon",), lon)
    var("hyam", ("lev",), hyam)
    var("hybm", ("lev",), hybm)
    f.P0 = 1.0e5          # attribute: scipy's 0-d variable write is broken
    var("PS", ("time", "lat", "lon"),
        1.0e5 - 500.0 * rng.random((n_time, n_lat, n_lon)))
    for i, sp in enumerate(species):
        base = 10.0 ** (-9 + 0.2 * i)
        field = base * (1.0 + 0.5 * np.sin(np.deg2rad(lat))[None, None, :,
                                                            None]
                        + 0.1 * rng.random((n_time, n_lev, n_lat, n_lon)))
        var(sp, ("time", "lev", "lat", "lon"), field)
    f.flush()
    f.close()
