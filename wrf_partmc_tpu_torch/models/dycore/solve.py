"""The dycore timestep dispatcher and the helpers the ARW core shares.

Port of the parts of ``wrf_partmc_tpu/models/dycore/solve.py`` that the ARW
path reaches: :class:`StepDiag`, the horizontal Smagorinsky closure, and
``solve_step``, which dispatches to the ARW core only.  The round-1 linear
core of that module is not carried.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...config import Config
from ...grid import Grid
from ...ops.advection import OutflowProbs
from ...ops.stencil import AXIS_X, AXIS_Y, shift
from .state import DycoreState


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


def horizontal_k(state: DycoreState, grid: Grid, cfg: Config):
    """Eddy diffusivity of the slow-variable mixing (diff_opt 1 or 2 with
    km_opt=4); the prognostic-TKE closure (km_opt=2) is not ported."""
    dyn = cfg.dynamics
    if dyn.diff_opt == 1:
        return dyn.khdif
    if dyn.km_opt == 2:
        raise NotImplementedError("km_opt=2 (prognostic TKE) is not ported")
    return smagorinsky_khh(state, grid, cfg)


def solve_step(state: DycoreState, grid: Grid, cfg: Config):
    """One full dycore timestep on the ARW core.  Returns
    (new_state, StepDiag)."""
    if cfg.dynamics.dyn_opt != "arw" or state.mu is None:
        raise NotImplementedError("only the ARW core (dyn_opt='arw') is ported")
    from .arw import solve_step_arw

    return solve_step_arw(state, grid, cfg)
