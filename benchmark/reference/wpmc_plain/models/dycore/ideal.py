"""Idealized-case initializers.

Port of ``wrf_partmc_tpu/models/dycore/ideal.py``: em_uniform and
em_rotational (the transport-verification cases, a smooth tracer blob whose
Eulerian advection doubles as the ground truth for the particle
transport), the warm bubble, the single-column state, and the
mass-coordinate cases (rest state, hill terrain, warm bubble, density
current).  Every field is built in float32 on the grid's device with the
reference's operations, so both packages start from the same state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...config import Config
from ...grid import Grid
from .state import DycoreState, replace, zero_dycore_state


def _xy(grid: Grid):
    """Cell-center x and y [m], each [ny, nx]."""
    dev = grid.dz.device
    x = (torch.arange(grid.nx, dtype=torch.float32, device=dev) + 0.5) * grid.dx
    y = (torch.arange(grid.ny, dtype=torch.float32, device=dev) + 0.5) * grid.dy
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return xx, yy


def gaussian_blob(grid: Grid, x0_frac=0.5, y0_frac=0.5, radius_frac=0.1,
                  amplitude=1.0):
    """[ny, nx] Gaussian blob (the rotating-cone / uniform-advection IC)."""
    xx, yy = _xy(grid)
    lx, ly = grid.nx * grid.dx, grid.ny * grid.dy
    r2 = (xx - x0_frac * lx) ** 2 + (yy - y0_frac * ly) ** 2
    sig = radius_frac * min(lx, ly)
    # the reference's exp flushes float32 subnormals to 0 (XLA-CPU), so its
    # far field is exactly 0 and holds no particle; flushed here alike
    e = torch.exp(-0.5 * r2 / sig ** 2)
    return amplitude * torch.where(e >= torch.finfo(torch.float32).tiny, e, 0.0)


def init_uniform(cfg: Config, grid: Grid, u0=10.0, v0=5.0,
                 blob_conc=1.0e9) -> DycoreState:
    """em_uniform: constant horizontal wind, blob of aerosol number conc in
    every class."""
    s = zero_dycore_state(cfg, grid)
    blob = gaussian_blob(grid, 0.35, 0.35, 0.08, blob_conc)
    num = blob.expand(cfg.n_class, grid.nz, grid.ny, grid.nx).contiguous()
    return replace(s, u=torch.full_like(s.u, u0), v=torch.full_like(s.v, v0),
                   num_conc=num)


def init_rotational(cfg: Config, grid: Grid, period_s=None,
                    blob_conc=1.0e9) -> DycoreState:
    """em_rotational: solid-body rotation about the domain center, each
    level an independent realization.  Default period: one revolution per
    100 dt."""
    s = zero_dycore_state(cfg, grid)
    if period_s is None:
        period_s = 100.0 * cfg.dynamics.dt
    omega = 2.0 * math.pi / period_s
    lx, ly = grid.nx * grid.dx, grid.ny * grid.dy
    xc, yc = 0.5 * lx, 0.5 * ly
    xx, yy = _xy(grid)
    # u depends only on y (the same at x-faces as at centers); v only on x
    shape = (grid.nz, grid.ny, grid.nx)
    u = (-omega * (yy - yc)).expand(shape).contiguous()
    v = (omega * (xx - xc)).expand(shape).contiguous()
    blob = gaussian_blob(grid, 0.5, 0.75, 0.06, blob_conc)
    num = blob.expand(cfg.n_class, *shape).contiguous()
    return replace(s, u=u, v=v, num_conc=num)


def init_warm_bubble(cfg: Config, grid: Grid, d_theta=2.0,
                     radius_frac=0.15) -> DycoreState:
    """Warm bubble: a +d_theta K thermal near the surface at the domain
    center (buoyancy and the implicit acoustic w solve)."""
    s = zero_dycore_state(cfg, grid)
    xx, yy = _xy(grid)
    lx, ly = grid.nx * grid.dx, grid.ny * grid.dy
    sig_h = radius_frac * min(lx, ly)
    zc = 0.25 * grid.z_full[-1]
    sig_z = 0.15 * grid.z_full[-1]
    r2h = ((xx - 0.5 * lx) ** 2 + (yy - 0.5 * ly) ** 2) / sig_h ** 2
    z = grid.z_half.reshape(-1, 1, 1)
    r2 = r2h[None] + ((z - zc) / sig_z) ** 2
    return replace(s, theta_p=d_theta * torch.exp(-0.5 * r2))


def init_scm(cfg: Config, grid: Grid, u0=5.0, exch_h0=50.0) -> DycoreState:
    """em_scm_xy analogue: a horizontally homogeneous column state; vertical
    mixing comes from a prescribed exch_h profile."""
    s = zero_dycore_state(cfg, grid)
    return replace(s, u=torch.full_like(s.u, u0))


def arw_rest_state(cfg: Config, grid: Grid) -> DycoreState:
    """The state exactly at the terrain-following hydrostatic base state:
    mu' = 0, phi' = 0, theta' = 0, at rest."""
    s = zero_dycore_state(cfg, grid)
    dev = grid.dz.device
    return replace(s, mu=torch.zeros((grid.ny, grid.nx), dtype=torch.float32, device=dev),
                   ph=torch.zeros((grid.nz + 1, grid.ny, grid.nx), dtype=torch.float32,
                                  device=dev))


def hill_terrain(cfg: Config, h0=400.0, half_width_frac=0.15,
                 x0_frac=0.5, y0_frac=0.5, ridge=False):
    """[ny, nx] float64 numpy Witch-of-Agnesi hill (or y-invariant ridge),
    for ``make_grid(cfg, hgt=...)``."""
    d = cfg.domain
    x = (np.arange(d.nx) + 0.5) * d.dx
    y = (np.arange(d.ny) + 0.5) * d.dy
    lx, ly = d.nx * d.dx, d.ny * d.dy
    a = half_width_frac * lx
    dx2 = (x[None, :] - x0_frac * lx) ** 2
    if ridge:
        r2 = dx2 + 0.0 * y[:, None]
    else:
        r2 = dx2 + (y[:, None] - y0_frac * ly) ** 2
    return h0 / (1.0 + r2 / a ** 2)


def init_warm_bubble_arw(cfg: Config, grid: Grid, d_theta=2.0,
                         radius_frac=0.12, z_center=1500.0,
                         z_radius=1000.0) -> DycoreState:
    """Warm bubble on the mass-coordinate core; mu' and phi' start at zero
    and the acoustic step adjusts within the first substeps."""
    s = arw_rest_state(cfg, grid)
    blob = gaussian_blob(grid, 0.5, 0.5, radius_frac, 1.0)
    zc = 0.5 * (grid.phb[1:] + grid.phb[:-1]) / 9.81          # [nz, ny, nx]
    zfac = torch.exp(-0.5 * ((zc - z_center) / z_radius) ** 2)
    return replace(s, theta_p=d_theta * blob[None] * zfac)


def init_density_current_arw(cfg: Config, grid: Grid, d_theta=-6.0,
                             z_center=3000.0, z_radius=2000.0,
                             radius_frac=0.1) -> DycoreState:
    """Straka-style density current: a cold blob aloft collapses and spreads
    along the ground."""
    return init_warm_bubble_arw(cfg, grid, d_theta=d_theta,
                                radius_frac=radius_frac, z_center=z_center,
                                z_radius=z_radius)
