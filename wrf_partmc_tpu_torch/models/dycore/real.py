"""Real-data initialization: wrfinput-like NetCDF -> ARW core state.

Port of ``wrf_partmc_tpu/models/dycore/real.py``, the real-case on-ramp
(``WRFV3/main/real_em.F`` + ``dyn_em/module_initialize_real.F``): read a
wrfinput-style file (terrain, map-projection metadata, winds, potential
temperature, moisture, surface pressure), rebuild the terrain-following base
state, and rebalance the disturbance fields hydrostatically in the discrete
sense of the mass-coordinate core, so the vertical buoyancy residual of
``arw._slow_tendencies`` is zero at the initial state.  The balance is built
in float64 on the host, as in the reference, and stored as float32 on the
grid's device.

The file schema is wrfinput's (dims ``west_east[_stag]``,
``south_north[_stag]``, ``bottom_top``; vars HGT, U, V, T (theta - 300),
QVAPOR, PSFC, XLAT/XLONG/MAPFAC_M/F; global attrs DX, DY, MAP_PROJ,
TRUELAT1/2, STAND_LON, CEN_LAT/LON, P_TOP); ``tools/make_inputs.py`` of
either package writes synthetic instances of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import constants as c
from ...config import Config
from ...grid import Grid, make_grid
from ...utils import llxy
from .state import DycoreState, zero_dycore_state


def _f64(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def hydrostatic_rebalance(theta_p, qv, mu_p, grid: Grid):
    """phi' [nz+1, ny, nx] in exact discrete hydrostatic balance with
    (theta', qv, mu'): the buoyancy term of the w equation
    (g[ratio dp'/deta + (ratio-1) mub - mu']) vanishes at the returned
    state.  Float64 on the host: integrate the face balance
    p'_{k-1} - p'_k = def_f (mu' - (ratio_f - 1) mub) / ratio_f downward
    from a continuum-limit top-layer seed, then invert the EOS of
    ``arw._eos`` layer by layer for dphi' (closed form: pb_eff is base-state
    only)."""
    th = np.asarray(theta_p, np.float64)
    qv = np.asarray(qv, np.float64)
    mu_p = np.asarray(mu_p, np.float64)
    nz = grid.nz
    deta = _f64(grid.deta).reshape(-1, 1, 1)
    eta_half = _f64(grid.eta_half)
    mub = _f64(grid.mub)
    phbd = np.diff(_f64(grid.phb), axis=0)
    alb_eff = phbd / (mub[None] * deta)
    pb_eff = c.P0 * (c.R_D * c.T0 / (c.P0 * alb_eff)) ** c.GAMMA

    ratio = 1.0 / (1.0 + qv)                        # alpha/alpha_d (init: qv)
    ratio_f = 0.5 * (ratio[:-1] + ratio[1:])        # interior faces 1..nz-1
    def_f = (eta_half[:-1] - eta_half[1:]).reshape(-1, 1, 1)

    # top-layer seed: continuum dp/deta = mu_d/ratio against base dpb/deta = mub
    mu_d = mub + mu_p
    p_pert = np.zeros((nz,) + mub.shape)
    p_pert[nz - 1] = eta_half[nz - 1] * (mu_d / ratio[nz - 1] - mub)
    for k in range(nz - 1, 0, -1):
        p_pert[k - 1] = p_pert[k] + def_f[k - 1] * (
            mu_p - (ratio_f[k - 1] - 1.0) * mub) / ratio_f[k - 1]

    # invert the EOS split for dphi':
    #   p' = pb_eff expm1(gamma ln r),  r = F / (1 + dphi'/dphib)
    #   F = (1 + theta'/T0)(1 + Rv/Rd qv)(1 + mu'/mub)
    r = np.exp(np.log1p(p_pert / pb_eff) / c.GAMMA)
    F = ((1.0 + th / c.T0) * (1.0 + (c.R_V / c.R_D) * qv)
         * (1.0 + mu_p / mub)[None])
    dphi_p = phbd * (F / r - 1.0)
    ph_p = np.zeros((nz + 1,) + mub.shape)
    ph_p[1:] = np.cumsum(dphi_p, axis=0)
    return torch.as_tensor(ph_p.astype(np.float32), device=grid.dz.device)


def init_real_from_arrays(cfg: Config, grid: Grid, u, v, theta_p, qv,
                          psfc=None) -> DycoreState:
    """A hydrostatically rebalanced ARW state from mass-point arrays (u/v
    already on owner faces, [nz, ny, nx]); ``psfc`` [ny, nx], the full moist
    surface pressure, sets mu' (one-pass vapor-column correction, the
    real_em dry-pressure adjustment)."""
    deta = _f64(grid.deta).reshape(-1, 1, 1)
    qv64 = np.asarray(qv, np.float64)
    if psfc is not None:
        # p_half = p_top + mu_base * eta_half (the grid's base construction)
        p_top = float(grid.p_base[0].cpu().numpy()
                      - float(grid.mu_base) * float(grid.eta_half[0]))
        wet_col = np.sum(qv64 * deta, axis=0)
        mu_d = (np.asarray(psfc, np.float64) - p_top) / (1.0 + wet_col)
        mu_p = mu_d - _f64(grid.mub)
    else:
        mu_p = np.zeros((grid.ny, grid.nx))
    s = zero_dycore_state(cfg, grid)
    dev = grid.dz.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    moist = s.moist.clone()
    moist[0] = f32(qv)
    return dataclasses.replace(
        s, u=f32(u), v=f32(v), theta_p=f32(theta_p), moist=moist, mu=f32(mu_p),
        ph=hydrostatic_rebalance(theta_p, qv64, mu_p, grid))


def read_wrfinput(path: str) -> dict:
    """The wrfinput-like schema as numpy arrays and projection attributes."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    g = lambda n: np.array(f.variables[n][:]) if n in f.variables else None
    out = dict(
        hgt=g("HGT"), u_stag=g("U"), v_stag=g("V"), t=g("T"),
        qvapor=g("QVAPOR"), psfc=g("PSFC"),
        xlat=g("XLAT"), xlong=g("XLONG"), msft=g("MAPFAC_M"), f_cor=g("F"),
        ivgtyp=g("IVGTYP"), isltyp=g("ISLTYP"),
    )
    for a in ("DX", "DY", "MAP_PROJ", "TRUELAT1", "TRUELAT2", "STAND_LON",
              "CEN_LAT", "CEN_LON", "P_TOP"):
        out[a.lower()] = getattr(f, a, None)
    f.close()
    return out


_PROJ_BY_CODE = {1: llxy.PROJ_LC, 2: llxy.PROJ_PS, 3: llxy.PROJ_MERC,
                 6: llxy.PROJ_LATLON}


def init_real(cfg: Config, path: str, device="cpu"):
    """wrfinput-like file -> (grid, state, surface categories) on
    ``device``: the real_em on-ramp.  The base state is rebuilt by
    :func:`make_grid`; map factors and Coriolis come from the file when
    present, else from its MAP_PROJ metadata through :mod:`utils.llxy`."""
    d = read_wrfinput(path)
    cfg_d = cfg.domain
    hgt = d["hgt"]
    if hgt.shape != (cfg_d.ny, cfg_d.nx):
        raise ValueError(f"wrfinput grid {hgt.shape} != config {(cfg_d.ny, cfg_d.nx)}")
    grid = make_grid(cfg, device=device, hgt=hgt)

    msft, f_cor = d["msft"], d["f_cor"]
    if (msft is None or f_cor is None) and d["map_proj"] is not None:
        kind = _PROJ_BY_CODE.get(int(d["map_proj"]))
        if kind is not None:
            proj = llxy.make_projection(
                kind, float(d["cen_lat"]), float(d["cen_lon"]), float(d["dx"]),
                stdlon=float(d["stand_lon"]), truelat1=float(d["truelat1"]),
                truelat2=float(d["truelat2"]))
            _, _, msft, f_cor = llxy.grid_geography(proj, cfg_d.nx, cfg_d.ny)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if msft is not None:
        grid = dataclasses.replace(grid, msft=f32(msft))
    if f_cor is not None:
        grid = dataclasses.replace(grid, f_cor=f32(f_cor))

    # unstagger: wrfinput U [nz, ny, nx+1] west faces -> owner-face u = U[:nx]
    u = d["u_stag"][..., :cfg_d.nx]
    v = d["v_stag"][..., :cfg_d.ny, :]
    state = init_real_from_arrays(cfg, grid, u, v, d["t"], d["qvapor"], psfc=d["psfc"])
    return grid, state, {"ivgtyp": d["ivgtyp"], "isltyp": d["isltyp"]}
