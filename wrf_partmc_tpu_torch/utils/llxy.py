"""Map projections: lat/lon <-> grid (i, j), map factors, Coriolis.

The port's own copy of ``wrf_partmc_tpu/utils/llxy.py`` (plain numpy, no
JAX in it): the projections WRF-ARW real cases use, as in
``WRFV3/share/module_llxy.F`` -- Lambert conformal (LC), polar
stereographic (PS), Mercator and regular lat-lon.  i/j are 1-based grid
indices of the mass grid, truelat1/2 in degrees, stdlon the standard
meridian.  Everything runs at setup time in float64; the msft/f fields it
returns are what the solver reads (``grid.msft`` / ``grid.f_cor``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

EARTH_RADIUS_M = 6_370_000.0          # WRF's spherical earth radius
OMEGA_E = 7.292e-5                    # earth angular velocity [s-1]

PROJ_LC = "lambert"
PROJ_PS = "polar"
PROJ_MERC = "mercator"
PROJ_LATLON = "lat-lon"


@dataclass(frozen=True)
class Projection:
    """Static projection descriptor (the proj_info derived type of
    module_llxy; set_ps/set_lc/set_merc equivalents in make_projection)."""

    kind: str
    lat1: float           # latitude of grid point (1, 1) [deg]
    lon1: float           # longitude of grid point (1, 1) [deg]
    dx: float             # grid spacing at truelat [m]
    stdlon: float = 0.0
    truelat1: float = 60.0
    truelat2: float = 60.0
    hemi: float = 1.0     # +1 northern, -1 southern
    cone: float = 1.0     # LC cone factor
    rebydx: float = 1.0   # earth radius / dx
    polei: float = 0.0    # PS/LC: i of the pole
    polej: float = 0.0
    rsw: float = 0.0      # Mercator: projected y of (1,1)
    dlon: float = 0.0     # Mercator/latlon scale


def _deg2rad(d):
    return np.asarray(d, dtype=np.float64) * np.pi / 180.0


def make_projection(kind: str, lat1: float, lon1: float, dx: float,
                    stdlon: float = 0.0, truelat1: float = 60.0,
                    truelat2: float | None = None) -> Projection:
    """proj_init: precompute the static projection constants."""
    if truelat2 is None:
        truelat2 = truelat1
    hemi = 1.0 if truelat1 >= 0 else -1.0
    rebydx = EARTH_RADIUS_M / dx
    p = Projection(kind=kind, lat1=lat1, lon1=lon1, dx=dx, stdlon=stdlon,
                   truelat1=truelat1, truelat2=truelat2, hemi=hemi,
                   rebydx=rebydx)
    if kind == PROJ_LC:
        tl1, tl2 = _deg2rad(abs(truelat1)), _deg2rad(abs(truelat2))
        if abs(truelat1 - truelat2) > 0.1:
            cone = (np.log(np.cos(tl1)) - np.log(np.cos(tl2))) / (
                np.log(np.tan(np.pi / 4 - tl1 / 2))
                - np.log(np.tan(np.pi / 4 - tl2 / 2)))
        else:
            cone = np.sin(tl1)
        p = dataclasses.replace(p, cone=float(cone))
        x1, y1 = _lc_xy(p, np.asarray(lat1), np.asarray(lon1))
        return dataclasses.replace(p, polei=float(x1), polej=float(y1))
    if kind == PROJ_PS:
        x1, y1 = _ps_xy(p, np.asarray(lat1), np.asarray(lon1))
        return dataclasses.replace(p, polei=float(x1), polej=float(y1))
    if kind == PROJ_MERC:
        clain = np.cos(_deg2rad(truelat1))
        dlon = dx / (EARTH_RADIUS_M * clain)
        rsw = np.log(np.tan(0.5 * (_deg2rad(lat1) + np.pi / 2))) / dlon
        return dataclasses.replace(p, dlon=float(dlon), rsw=float(rsw))
    if kind == PROJ_LATLON:
        dlon = dx / EARTH_RADIUS_M * 180.0 / np.pi
        return dataclasses.replace(p, dlon=float(dlon))
    raise ValueError(f"unknown projection {kind!r}")


def _lc_xy(p: Projection, lat, lon):
    """Lambert-conformal planar coordinates in grid units (pole at origin;
    x east along the standard meridian's normal, y increasing northward)."""
    chi = _deg2rad(90.0 - p.hemi * lat)
    chi1 = _deg2rad(90.0 - p.hemi * p.truelat1)
    rho = (p.rebydx * np.cos(_deg2rad(p.truelat1)) / p.cone
           * (np.tan(chi / 2) / np.tan(chi1 / 2)) ** p.cone)
    arg = p.cone * _deg2rad(_wrap_deg(lon - p.stdlon))
    return rho * np.sin(arg), -p.hemi * rho * np.cos(arg)


def _ps_xy(p: Projection, lat, lon):
    scale_top = 1.0 + p.hemi * np.sin(_deg2rad(p.truelat1))
    latr = _deg2rad(lat)
    rho = p.rebydx * np.cos(latr) * scale_top / (1.0 + p.hemi * np.sin(latr))
    arg = _deg2rad(_wrap_deg(lon - p.stdlon))
    return rho * np.sin(arg), -p.hemi * rho * np.cos(arg)


def _wrap_deg(d):
    d = np.asarray(d, dtype=np.float64)
    return (d + 180.0) % 360.0 - 180.0


def ij_to_latlon(p: Projection, i, j):
    """Grid (i, j) (1-based, float ok) -> (lat, lon) [deg]
    (ijll_* of module_llxy)."""
    i = np.asarray(i, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64)
    if p.kind == PROJ_LC:
        x = i - 1.0 + p.polei
        y = j - 1.0 + p.polej
        rho = np.sqrt(x ** 2 + y ** 2)
        chi1 = _deg2rad(90.0 - p.hemi * p.truelat1)
        scale = p.rebydx * np.cos(_deg2rad(p.truelat1)) / p.cone
        with np.errstate(divide="ignore", invalid="ignore"):
            chi = 2.0 * np.arctan(np.tan(chi1 / 2)
                                  * (rho / scale) ** (1.0 / p.cone))
        lat = np.where(rho == 0, p.hemi * 90.0,
                       p.hemi * (90.0 - chi * 180.0 / np.pi))
        arg = np.arctan2(x, -p.hemi * y)
        lon = _wrap_deg(p.stdlon + arg / p.cone * 180.0 / np.pi)
        return lat, lon
    if p.kind == PROJ_PS:
        x = i - 1.0 + p.polei
        y = j - 1.0 + p.polej
        rho = np.sqrt(x ** 2 + y ** 2)
        scale_top = 1.0 + p.hemi * np.sin(_deg2rad(p.truelat1))
        chi = 2.0 * np.arctan(rho / (p.rebydx * scale_top))
        lat = p.hemi * (90.0 - chi * 180.0 / np.pi)
        arg = np.arctan2(x, -p.hemi * y)
        lon = _wrap_deg(p.stdlon + arg * 180.0 / np.pi)
        return lat, lon
    if p.kind == PROJ_MERC:
        lat = 2.0 * np.arctan(np.exp(p.dlon * (p.rsw + j - 1.0))) \
            * 180.0 / np.pi - 90.0
        lon = _wrap_deg((i - 1.0) * p.dlon * 180.0 / np.pi + p.lon1)
        return lat, lon
    if p.kind == PROJ_LATLON:
        lat = p.lat1 + (j - 1.0) * p.dlon
        lon = _wrap_deg(p.lon1 + (i - 1.0) * p.dlon)
        return lat, lon
    raise ValueError(p.kind)


def latlon_to_ij(p: Projection, lat, lon):
    """(lat, lon) [deg] -> grid (i, j) (llij_* of module_llxy)."""
    lat = np.asarray(lat, dtype=np.float64)
    lon = np.asarray(lon, dtype=np.float64)
    if p.kind == PROJ_LC:
        x, y = _lc_xy(p, lat, lon)
        return x - p.polei + 1.0, y - p.polej + 1.0
    if p.kind == PROJ_PS:
        x, y = _ps_xy(p, lat, lon)
        return x - p.polei + 1.0, y - p.polej + 1.0
    if p.kind == PROJ_MERC:
        i = 1.0 + (_deg2rad(_wrap_deg(lon - p.lon1))) / p.dlon
        j = 1.0 - p.rsw + np.log(np.tan(0.5 * (_deg2rad(lat) + np.pi / 2))) \
            / p.dlon
        return i, j
    if p.kind == PROJ_LATLON:
        return 1.0 + _wrap_deg(lon - p.lon1) / p.dlon, \
            1.0 + (lat - p.lat1) / p.dlon
    raise ValueError(p.kind)


def map_factor(p: Projection, lat):
    """Map scale factor m(lat) (the msft/msfu/msfv fields)."""
    latr = _deg2rad(lat)
    if p.kind == PROJ_LC:
        chi1 = (90.0 - p.hemi * p.truelat1) * np.pi / 180.0
        chi = (90.0 - p.hemi * np.asarray(lat)) * np.pi / 180.0
        return (np.sin(chi1) / np.sin(chi)
                * (np.tan(chi * 0.5) / np.tan(chi1 * 0.5)) ** p.cone)
    if p.kind == PROJ_PS:
        return (1.0 + p.hemi * np.sin(_deg2rad(p.truelat1))) \
            / (1.0 + p.hemi * np.sin(latr))
    if p.kind == PROJ_MERC:
        return np.cos(_deg2rad(p.truelat1)) / np.cos(latr)
    if p.kind == PROJ_LATLON:
        return 1.0 / np.maximum(np.cos(latr), 1e-6)
    raise ValueError(p.kind)


def grid_geography(p: Projection, nx: int, ny: int):
    """(lat, lon, msft, f_cor) 2-D [ny, nx] fields for the mass grid —
    what real-case init stores into the Grid (xlat/xlong/msft/f)."""
    jj, ii = np.meshgrid(np.arange(1, ny + 1, dtype=np.float64),
                         np.arange(1, nx + 1, dtype=np.float64),
                         indexing="ij")
    lat, lon = ij_to_latlon(p, ii, jj)
    msft = map_factor(p, lat)
    f = 2.0 * OMEGA_E * np.sin(_deg2rad(lat))
    return lat, lon, msft, f
