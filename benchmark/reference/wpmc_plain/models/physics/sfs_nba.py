"""Nonlinear Backscatter and Anisotropy (NBA1) LES subfilter stress
(sfs_opt=1).

Port of ``wrf_partmc_tpu/models/physics/sfs_nba.py`` (Kosovic 1997;
Mirocha, Lundquist & Kosovic 2010): beyond the linear eddy viscosity, the
stress carries strain-strain and strain-rotation products,

  tau_ij = -(c_s Delta)^2 [ 2 (2 S_mn S_mn)^{1/2} S_ij
            + C1 (S_ik S_kj - 1/3 S_mn S_mn delta_ij)
            + C2 (S_ik R_kj - R_ik S_kj) ],

all at cell centres from centred differences of the de-staggered winds,
with the stress divergence by centred differences too.
"""

from __future__ import annotations

import math

import torch

from ...grid import Grid
from ...ops.stencil import AXIS_X, AXIS_Y, shift

C_B = 0.36
C_S = math.sqrt(8.0 * (1.0 + C_B) / (27.0 * math.pi ** 2))    # ~ 0.226
C_1 = C_2 = 0.42


def _ddx(f, rdx, bx):
    return (shift(f, 1, AXIS_X, bx) - shift(f, -1, AXIS_X, bx)) * 0.5 * rdx


def _ddy(f, rdy, by):
    return (shift(f, 1, AXIS_Y, by) - shift(f, -1, AXIS_Y, by)) * 0.5 * rdy


def _ddz(f, dz):
    """Centred d/dz at half levels from half-level values [nz, ...]."""
    up = torch.cat([f[1:], f[-1:]], dim=0)
    dn = torch.cat([f[:1], f[:-1]], dim=0)
    return (up - dn) / (2.0 * dz)


def nba_stress_tendencies(u_c, v_c, w_c, grid: Grid, bx: str, by: str,
                          return_stress: bool = False):
    """(du/dt, dv/dt, dw/dt) [m s-2] from the NBA1 stress divergence;
    u_c/v_c/w_c are the cell-centre winds [nz, ny, nx].  With
    ``return_stress`` also the six stresses (t11, t12, t13, t22, t23,
    t33)."""
    rdx, rdy = grid.rdx, grid.rdy
    dz = grid.dz.reshape(-1, 1, 1)
    delta = (grid.dx * grid.dy * torch.mean(grid.dz)) ** (1.0 / 3.0)

    dudx, dudy, dudz = _ddx(u_c, rdx, bx), _ddy(u_c, rdy, by), _ddz(u_c, dz)
    dvdx, dvdy, dvdz = _ddx(v_c, rdx, bx), _ddy(v_c, rdy, by), _ddz(v_c, dz)
    dwdx, dwdy, dwdz = _ddx(w_c, rdx, bx), _ddy(w_c, rdy, by), _ddz(w_c, dz)

    s11, s22, s33 = dudx, dvdy, dwdz
    s12 = 0.5 * (dudy + dvdx)
    s13 = 0.5 * (dudz + dwdx)
    s23 = 0.5 * (dvdz + dwdy)
    r12 = 0.5 * (dudy - dvdx)
    r13 = 0.5 * (dudz - dwdx)
    r23 = 0.5 * (dvdz - dwdy)

    ss = (s11 ** 2 + s22 ** 2 + s33 ** 2
          + 2.0 * (s12 ** 2 + s13 ** 2 + s23 ** 2))
    smag = torch.sqrt(2.0 * ss)
    cfac = (C_S * delta) ** 2
    S = {(1, 1): s11, (2, 2): s22, (3, 3): s33,
         (1, 2): s12, (2, 1): s12, (1, 3): s13, (3, 1): s13,
         (2, 3): s23, (3, 2): s23}
    R = {(1, 2): r12, (2, 1): -r12, (1, 3): r13, (3, 1): -r13,
         (2, 3): r23, (3, 2): -r23, (1, 1): 0.0, (2, 2): 0.0, (3, 3): 0.0}

    def sdots(i, j):
        """(S S)_ij = S_ik S_kj."""
        return sum(S[(i, k)] * S[(k, j)] for k in (1, 2, 3))

    def sdotr(i, j):
        """(S R - R S)_ij."""
        return sum(S[(i, k)] * R[(k, j)] - R[(i, k)] * S[(k, j)] for k in (1, 2, 3))

    third_ss = ss / 3.0

    def tau(i, j):
        t = 2.0 * smag * S[(i, j)] + C_1 * sdots(i, j) + C_2 * sdotr(i, j)
        if i == j:
            t = t - C_1 * third_ss
        return -cfac * t

    t11, t12, t13 = tau(1, 1), tau(1, 2), tau(1, 3)
    t22, t23, t33 = tau(2, 2), tau(2, 3), tau(3, 3)

    du = -(_ddx(t11, rdx, bx) + _ddy(t12, rdy, by) + _ddz(t13, dz))
    dv = -(_ddx(t12, rdx, bx) + _ddy(t22, rdy, by) + _ddz(t23, dz))
    dw = -(_ddx(t13, rdx, bx) + _ddy(t23, rdy, by) + _ddz(t33, dz))
    if return_stress:
        return (du, dv, dw), (t11, t12, t13, t22, t23, t33)
    return du, dv, dw
