"""The dycore timestep dispatcher and the helpers the ARW core shares.

Port of the parts of ``wrf_partmc_tpu/models/dycore/solve.py`` that the ARW
path reaches: :class:`StepDiag`, the horizontal Smagorinsky closure, the
prognostic subgrid TKE (km_opt=2: N^2, the eddy coefficients and the TKE
advance, with the two advection helpers it uses), and ``solve_step``,
which dispatches to the ARW core only.  The round-1 linear core of that
module is not carried.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ... import constants as c
from ...config import Config
from ...grid import Grid
from ...ops.advection import OutflowProbs, face_fluxes, flux_divergence
from ...ops.stencil import AXIS_X, AXIS_Y, shift
from .state import DycoreState, base_profiles


@dataclass(frozen=True)
class StepDiag:
    """Per-step diagnostics consumed by the particle transport."""

    probs: OutflowProbs      # per-class outflow probabilities [n_class, ...]
    xkhh: torch.Tensor       # horizontal eddy diffusivity [nz, ny, nx]
    rho_u: torch.Tensor      # time-averaged mass-flux winds
    rho_v: torch.Tensor
    rho_w: torch.Tensor


def bc_pair(cfg: Config):
    bx = "periodic" if cfg.boundary.periodic_x else "clamp"
    by = "periodic" if cfg.boundary.periodic_y else "clamp"
    return bx, by


def laplacian_h(f, rdx, rdy, bc_x, bc_y):
    return ((shift(f, 1, AXIS_X, bc_x) - 2 * f + shift(f, -1, AXIS_X, bc_x)) * rdx ** 2
            + (shift(f, 1, AXIS_Y, bc_y) - 2 * f + shift(f, -1, AXIS_Y, bc_y)) * rdy ** 2)


def deformation_mag(state: DycoreState, grid: Grid, cfg: Config):
    """Horizontal deformation magnitude |D| at cell centers."""
    bx, by = bc_pair(cfg)
    rdx, rdy = grid.rdx, grid.rdy
    u_c = 0.5 * (state.u + shift(state.u, 1, AXIS_X, bx))
    v_c = 0.5 * (state.v + shift(state.v, 1, AXIS_Y, by))
    d11 = (shift(state.u, 1, AXIS_X, bx) - state.u) * rdx
    d22 = (shift(state.v, 1, AXIS_Y, by) - state.v) * rdy
    dudy = (shift(u_c, 1, AXIS_Y, by) - shift(u_c, -1, AXIS_Y, by)) * 0.5 * rdy
    dvdx = (shift(v_c, 1, AXIS_X, bx) - shift(v_c, -1, AXIS_X, bx)) * 0.5 * rdx
    d12 = 0.5 * (dudy + dvdx)
    return torch.sqrt(d11 ** 2 + d22 ** 2 + 2.0 * d12 ** 2)


def smagorinsky_khh(state: DycoreState, grid: Grid, cfg: Config):
    """2-D Smagorinsky closure (km_opt=4): K = (c_s dx)^2 |D|."""
    return (cfg.dynamics.smag_cs * grid.dx) ** 2 * deformation_mag(state, grid, cfg)


def _rho_faces(rho_b):
    """Base density at w levels [nz+1] (edge-extrapolated)."""
    mid = 0.5 * (rho_b[1:] + rho_b[:-1])
    return torch.cat([rho_b[:1], mid, rho_b[-1:]])


def _advective_tendency(f, mfx, mfy, mfz, rho_col, rdx, rdy, rdz, h_order,
                        v_order, bc_x, bc_y):
    """Advective-form tendency -v.grad(f), as the flux form minus f times
    the mass divergence."""
    fx, fy, fz = face_fluxes(f, mfx, mfy, mfz, h_order, v_order, bc_x, bc_y)
    div_f = flux_divergence(fx, fy, fz, rdx, rdy, rdz)
    div_m = ((shift(mfx, 1, AXIS_X, bc_x) - mfx) * rdx
             + (shift(mfy, 1, AXIS_Y, bc_y) - mfy) * rdy
             + (mfz[..., 1:, :, :] - mfz[..., :-1, :, :]) * rdz.reshape(-1, 1, 1))
    return -(div_f - f * div_m) / rho_col


def brunt_vaisala_sq(state: DycoreState, grid: Grid):
    """Moist-free N^2 = (g/theta) dtheta/dz at cell centers [nz, ny, nx]."""
    _, theta_b, _ = base_profiles(grid)
    th = theta_b.reshape(-1, 1, 1) + state.theta_p
    zh = grid.z_half
    # spacing matched to the dth stencil: one-sided ends, centered interior
    dz_f = torch.cat([zh[1:2] - zh[0:1], 0.5 * (zh[2:] - zh[:-2]),
                      zh[-1:] - zh[-2:-1]])
    dth = torch.cat([th[1:2] - th[0:1], 0.5 * (th[2:] - th[:-2]),
                     th[-1:] - th[-2:-1]], dim=0)
    dthdz = dth / dz_f.reshape(-1, 1, 1)
    return (c.GRAV / th) * dthdz


def tke_eddy_coeffs(state: DycoreState, grid: Grid, cfg: Config):
    """Eddy viscosities of the 1.5-order TKE closure (km_opt=2):
    K_m = 0.1 l sqrt(e) with l = min(Delta, 0.76 sqrt(e/N^2)),
    K_h = (1 + 2 l / Delta) K_m.  Returns (km, kh, length, delta)."""
    e = torch.clamp(state.tke, min=cfg.dynamics.tke_seed)
    delta = (grid.dx * grid.dy * grid.dz.mean()) ** (1.0 / 3.0)
    n2 = brunt_vaisala_sq(state, grid)
    l_stable = 0.76 * torch.sqrt(e / torch.clamp(n2, min=1e-10))
    length = torch.where(n2 > 1e-10, torch.minimum(delta, l_stable), delta)
    km = 0.10 * length * torch.sqrt(e)
    kh = (1.0 + 2.0 * length / delta) * km
    return km, kh, length, delta


def tke_advance(state: DycoreState, grid: Grid, cfg: Config, dt: float):
    """One forward step of de/dt = -v.grad(e) + K_m |D|^2 - K_h N^2
    - C_eps e^(3/2)/l + 2 K_m lap_h(e), e floored at tke_seed.  Returns
    (e_new, kh)."""
    bx, by = bc_pair(cfg)
    rho_b, _, _ = base_profiles(grid)
    rho_c = rho_b.reshape(-1, 1, 1)
    rho_f = _rho_faces(rho_b)
    rdz = 1.0 / grid.dz
    km, kh, length, delta = tke_eddy_coeffs(state, grid, cfg)
    adv = _advective_tendency(state.tke, rho_c * state.u, rho_c * state.v,
                              rho_f.reshape(-1, 1, 1) * state.w, rho_c,
                              grid.rdx, grid.rdy, rdz, 2, 2, bx, by)
    p_shear = km * deformation_mag(state, grid, cfg) ** 2
    p_buoy = -kh * brunt_vaisala_sq(state, grid)
    c_eps = 1.9 * (0.93 + 0.07 * length / delta)
    e = torch.clamp(state.tke, min=0.0)
    diss = c_eps * e ** 1.5 / torch.clamp(length, min=1e-3)
    diff = 2.0 * km * laplacian_h(e, grid.rdx, grid.rdy, bx, by)
    e_new = e + dt * (adv + p_shear + p_buoy - diss + diff)
    return torch.clamp(e_new, min=cfg.dynamics.tke_seed), kh


def horizontal_k(state: DycoreState, grid: Grid, cfg: Config):
    """Eddy diffusivity of the slow-variable mixing: khdif (diff_opt=1),
    the TKE closure's K_h (diff_opt=2, km_opt=2) or Smagorinsky."""
    dyn = cfg.dynamics
    if dyn.diff_opt == 1:
        return dyn.khdif
    if dyn.km_opt == 2:
        return tke_eddy_coeffs(state, grid, cfg)[1]
    return smagorinsky_khh(state, grid, cfg)


def solve_step(state: DycoreState, grid: Grid, cfg: Config):
    """One full dycore timestep on the ARW core.  Returns
    (new_state, StepDiag)."""
    if cfg.dynamics.dyn_opt != "arw" or state.mu is None:
        raise NotImplementedError("only the ARW core (dyn_opt='arw') is ported")
    from .arw import solve_step_arw

    return solve_step_arw(state, grid, cfg)
