"""Land-use and soil-texture parameter tables (LANDUSE.TBL / VEGPARM.TBL /
SOILPARM.TBL-class) for the Noah-class LSM.

Port of ``wrf_partmc_tpu/models/physics/landuse.py``: the USGS 24-category
land-use classes (summer/winter columns) and the 12 STAS soil-texture
classes, looked up per cell from 1-based category maps.
"""

from __future__ import annotations

import functools

import torch

# USGS 24-category land-use table.  Columns:
#   (name, albedo_summer, albedo_winter, z0_summer [m], z0_winter [m],
#    emissivity, vegfrac_summer, vegfrac_winter, rsmin [s/m], lai_summer,
#    lai_winter)
USGS_LANDUSE = (
    ("Urban and Built-Up Land",        0.15, 0.15, 0.80, 0.80, 0.88, 0.10, 0.10, 200.0, 1.0, 1.0),
    ("Dryland Cropland and Pasture",   0.17, 0.23, 0.15, 0.05, 0.92, 0.80, 0.30,  40.0, 3.0, 1.0),
    ("Irrigated Cropland and Pasture", 0.18, 0.23, 0.10, 0.05, 0.92, 0.80, 0.40,  40.0, 3.0, 1.5),
    ("Mixed Dry/Irrig Cropland",       0.18, 0.23, 0.15, 0.05, 0.92, 0.80, 0.35,  40.0, 3.0, 1.2),
    ("Cropland/Grassland Mosaic",      0.18, 0.23, 0.14, 0.05, 0.92, 0.70, 0.30,  40.0, 2.5, 1.0),
    ("Cropland/Woodland Mosaic",       0.16, 0.20, 0.20, 0.20, 0.93, 0.80, 0.40,  70.0, 3.5, 2.0),
    ("Grassland",                      0.19, 0.23, 0.12, 0.10, 0.92, 0.80, 0.30,  40.0, 2.5, 1.0),
    ("Shrubland",                      0.22, 0.25, 0.05, 0.06, 0.88, 0.70, 0.30, 300.0, 2.0, 1.0),
    ("Mixed Shrubland/Grassland",      0.20, 0.24, 0.06, 0.06, 0.90, 0.70, 0.30, 170.0, 2.2, 1.0),
    ("Savanna",                        0.20, 0.20, 0.15, 0.15, 0.92, 0.50, 0.30,  70.0, 2.0, 1.5),
    ("Deciduous Broadleaf Forest",     0.16, 0.17, 0.50, 0.50, 0.93, 0.80, 0.50, 100.0, 5.0, 1.5),
    ("Deciduous Needleleaf Forest",    0.14, 0.15, 0.50, 0.50, 0.94, 0.70, 0.50, 150.0, 5.0, 1.5),
    ("Evergreen Broadleaf Forest",     0.12, 0.12, 0.50, 0.50, 0.95, 0.95, 0.95, 150.0, 6.0, 5.0),
    ("Evergreen Needleleaf Forest",    0.12, 0.12, 0.50, 0.50, 0.95, 0.70, 0.70, 125.0, 6.0, 5.0),
    ("Mixed Forest",                   0.13, 0.14, 0.50, 0.50, 0.94, 0.80, 0.60, 125.0, 5.5, 3.0),
    ("Water Bodies",                   0.08, 0.08, 1e-4, 1e-4, 0.98, 0.00, 0.00, 100.0, 0.0, 0.0),
    ("Herbaceous Wetland",             0.14, 0.14, 0.20, 0.20, 0.95, 0.60, 0.40,  40.0, 4.0, 2.0),
    ("Wooded Wetland",                 0.14, 0.14, 0.40, 0.40, 0.95, 0.70, 0.50, 100.0, 5.0, 3.0),
    ("Barren or Sparsely Vegetated",   0.25, 0.25, 0.01, 0.01, 0.85, 0.01, 0.01, 999.0, 0.5, 0.5),
    ("Herbaceous Tundra",              0.15, 0.60, 0.10, 0.10, 0.92, 0.60, 0.20,  40.0, 1.0, 0.5),
    ("Wooded Tundra",                  0.15, 0.50, 0.30, 0.30, 0.93, 0.60, 0.20, 100.0, 2.0, 0.5),
    ("Mixed Tundra",                   0.15, 0.55, 0.15, 0.15, 0.92, 0.60, 0.20, 100.0, 1.5, 0.5),
    ("Bare Ground Tundra",             0.25, 0.70, 0.05, 0.05, 0.90, 0.30, 0.10, 999.0, 0.5, 0.5),
    ("Snow or Ice",                    0.55, 0.70, 0.001, 0.001, 0.95, 0.00, 0.00, 999.0, 0.0, 0.0),
)

# STAS 12-category soil-texture table (SOILPARM.TBL-class).  Columns:
#   (name, theta_sat [porosity], theta_fc [field capacity],
#    theta_wilt [wilting point], b [Clapp-Hornberger exponent],
#    k_sat [m/s], psi_sat [m], c_dry [J/m3/K])
STAS_SOIL = (
    ("Sand",            0.395, 0.174, 0.033,  4.05, 1.76e-4, 0.121, 1.47e6),
    ("Loamy Sand",      0.410, 0.179, 0.055,  4.38, 1.56e-4, 0.090, 1.41e6),
    ("Sandy Loam",      0.435, 0.249, 0.095,  4.90, 3.47e-5, 0.218, 1.34e6),
    ("Silt Loam",       0.485, 0.369, 0.133,  5.30, 7.20e-6, 0.786, 1.27e6),
    ("Silt",            0.476, 0.357, 0.126,  5.30, 7.00e-6, 0.759, 1.27e6),
    ("Loam",            0.451, 0.314, 0.117,  5.39, 6.95e-6, 0.478, 1.26e6),
    ("Sandy Clay Loam", 0.420, 0.299, 0.148,  7.12, 6.30e-6, 0.299, 1.27e6),
    ("Silty Clay Loam", 0.477, 0.357, 0.208,  7.75, 1.70e-6, 0.356, 1.18e6),
    ("Clay Loam",       0.476, 0.391, 0.197,  8.52, 2.45e-6, 0.630, 1.23e6),
    ("Sandy Clay",      0.426, 0.316, 0.239, 10.40, 2.17e-6, 0.153, 1.18e6),
    ("Silty Clay",      0.492, 0.409, 0.250, 10.40, 1.03e-6, 0.490, 1.15e6),
    ("Clay",            0.482, 0.400, 0.272, 11.40, 1.28e-6, 0.405, 1.09e6),
)

# default categories when no map is supplied (the pre-table behavior:
# cropland over loam, matching the old module constants' regime)
DEFAULT_IVGTYP = 2   # Dryland Cropland and Pasture (1-based USGS index)
DEFAULT_ISLTYP = 6   # Loam (1-based STAS index)


@functools.lru_cache(maxsize=None)
def _col(table, j, device):
    """Column ``j`` of a table as a float32 tensor, made once per device."""
    return torch.tensor([row[j] for row in table], dtype=torch.float32, device=device)


def landuse_params(ivgtyp, season: str = "summer"):
    """Per-cell vegetation parameters from a [ny, nx] 1-based USGS category
    map; ``season`` picks the summer or winter column."""
    i = torch.clamp(ivgtyp.long() - 1, 0, len(USGS_LANDUSE) - 1)
    s = 0 if season == "summer" else 1
    col = lambda j: _col(USGS_LANDUSE, j, ivgtyp.device)[i]
    return {
        "albedo": col(1 + s),
        "z0": col(3 + s),
        "emiss": col(5),
        "veg_frac": col(6 + s),
        "rsmin": col(8),
        "lai": col(9 + (1 if season != "summer" else 0)),
    }


def soil_params(isltyp):
    """Per-cell soil hydraulic/thermal parameters from a [ny, nx] 1-based
    STAS texture map."""
    i = torch.clamp(isltyp.long() - 1, 0, len(STAS_SOIL) - 1)
    col = lambda j: _col(STAS_SOIL, j, isltyp.device)[i]
    return {
        "theta_sat": col(1),
        "theta_fc": col(2),
        "theta_wilt": col(3),
        "b_ch": col(4),
        "k_sat": col(5),
        "psi_sat": col(6),
        "c_dry": col(7),
    }


def noah_params(ivgtyp, isltyp, season: str = "summer"):
    """Combined LANDUSE + SOILPARM lookup for the Noah-class LSM."""
    p = landuse_params(ivgtyp, season)
    p.update(soil_params(isltyp))
    return p
