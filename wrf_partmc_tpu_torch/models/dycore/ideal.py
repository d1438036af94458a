"""Idealized-case initializers (port of the em_uniform initializer of
``wrf_partmc_tpu/models/dycore/ideal.py``)."""

from __future__ import annotations

import torch

from ...config import Config
from ...grid import Grid
from .state import DycoreState, replace, zero_dycore_state


def gaussian_blob(grid: Grid, x0_frac=0.5, y0_frac=0.5, radius_frac=0.1,
                  amplitude=1.0):
    """[ny, nx] Gaussian blob (the uniform-advection IC)."""
    dev = grid.dz.device
    x = (torch.arange(grid.nx, dtype=torch.float32, device=dev) + 0.5) * grid.dx
    y = (torch.arange(grid.ny, dtype=torch.float32, device=dev) + 0.5) * grid.dy
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    lx, ly = grid.nx * grid.dx, grid.ny * grid.dy
    r2 = (xx - x0_frac * lx) ** 2 + (yy - y0_frac * ly) ** 2
    sig = radius_frac * min(lx, ly)
    return amplitude * torch.exp(-0.5 * r2 / sig ** 2)


def init_uniform(cfg: Config, grid: Grid, u0=10.0, v0=5.0,
                 blob_conc=1.0e9) -> DycoreState:
    """em_uniform: constant horizontal wind, blob of aerosol number conc in
    every class."""
    s = zero_dycore_state(cfg, grid)
    blob = gaussian_blob(grid, 0.35, 0.35, 0.08, blob_conc)
    num = blob.expand(cfg.n_class, grid.nz, grid.ny, grid.nx).contiguous()
    return replace(s, u=torch.full_like(s.u, u0), v=torch.full_like(s.v, v0),
                   num_conc=num)
