"""Dycore prognostic state (port of ``wrf_partmc_tpu/models/dycore/state.py``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ... import constants as c
from ...config import Config
from ...grid import Grid


@dataclass(frozen=True)
class DycoreState:
    """Prognostic fields on the C-grid (owner-face staggering, see grid.py)."""

    u: torch.Tensor          # [nz, ny, nx] x-wind at west faces [m s-1]
    v: torch.Tensor          # [nz, ny, nx] y-wind at south faces
    w: torch.Tensor          # [nz+1, ny, nx] z-wind at full (w) levels
    theta_p: torch.Tensor    # [nz, ny, nx] potential-temp perturbation [K]
    p_p: torch.Tensor        # [nz, ny, nx] pressure perturbation [Pa]
    moist: torch.Tensor      # [n_moist, nz, ny, nx] mixing ratios [kg kg-1]
    chem: torch.Tensor       # [n_gas, nz, ny, nx] gas mix ratios [ppm]
    num_conc: torch.Tensor   # [n_class, nz, ny, nx] number tracers [# kg-1]
    tke: torch.Tensor        # [nz, ny, nx] subgrid TKE [m2 s-2]
    mu: torch.Tensor | None = None   # [ny, nx] dry column-mass perturbation
    ph: torch.Tensor | None = None   # [nz+1, ny, nx] geopotential perturbation

    @property
    def nz(self) -> int:
        return self.u.shape[-3]


def zero_dycore_state(cfg: Config, grid: Grid) -> DycoreState:
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    dev = grid.dz.device
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    arw = cfg.dynamics.dyn_opt == "arw"
    return DycoreState(
        u=z(nz, ny, nx), v=z(nz, ny, nx), w=z(nz + 1, ny, nx),
        theta_p=z(nz, ny, nx), p_p=z(nz, ny, nx),
        moist=z(cfg.n_moist, nz, ny, nx),
        chem=z(cfg.n_chem_gas, nz, ny, nx),
        num_conc=z(cfg.n_class, nz, ny, nx),
        tke=torch.full((nz, ny, nx), cfg.dynamics.tke_seed,
                       dtype=torch.float32, device=dev),
        mu=z(ny, nx) if arw else None,
        ph=z(nz + 1, ny, nx) if arw else None,
    )


def base_profiles(grid: Grid):
    """Base-state column profiles: rho_b, theta_b, cs2."""
    rho_b = 1.0 / grid.alpha_base
    theta_b = grid.t_base
    cs2 = c.GAMMA * grid.p_base * grid.alpha_base
    return rho_b, theta_b, cs2


def total_pressure(state: DycoreState, grid: Grid):
    return grid.p_base.reshape(-1, 1, 1) + state.p_p


def temperature(state: DycoreState, grid: Grid):
    th = grid.t_base.reshape(-1, 1, 1) + state.theta_p
    p = total_pressure(state, grid)
    return th * (p / c.P0) ** c.KAPPA


def air_density(state: DycoreState, grid: Grid):
    """[nz, ny, nx] air density [kg m-3] from the full pressure and
    temperature (ideal gas, dry-air constant)."""
    p = total_pressure(state, grid)
    t = temperature(state, grid)
    return p / (c.R_D * t)


def layer_depths(state: DycoreState, grid: Grid, shape):
    """[nz, ny, nx] layer depths [m] of ``shape``: from the geopotential on
    the mass-coordinate core, the base-state depths on the linear core."""
    if state.ph is not None:
        return (grid.phb[1:] - grid.phb[:-1] + state.ph[1:] - state.ph[:-1]) / c.GRAV
    return grid.dz.reshape(-1, 1, 1).expand(shape)


def replace(state: DycoreState, **kw) -> DycoreState:
    return dataclasses.replace(state, **kw)
