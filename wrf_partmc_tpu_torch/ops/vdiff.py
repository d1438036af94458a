"""Implicit vertical diffusion of Eulerian fields.

Port of ``wrf_partmc_tpu/ops/vdiff.py``: backward-Euler column solve
(I - dt D) f^{n+1} = f^n with zero-flux ends, one tridiagonal system per
column through ``ops.tridiag.solve`` (kernel K1 on CUDA).
"""

from __future__ import annotations

import dataclasses

import torch

from ..grid import Grid
from .tridiag import solve as tridiag_solve


def vdiff_coeffs(kv_face, grid: Grid, rho_b, dt):
    """Tridiagonal coefficients (dl, d, du), each [nz, ny, nx], from the
    face diffusivity kv_face [nz+1, ny, nx]."""
    dz = grid.dz
    dzf = grid.z_half[1:] - grid.z_half[:-1]
    k_int = kv_face[1:-1]
    rho_f = 0.5 * (rho_b[1:] + rho_b[:-1])
    flux = (rho_f / dzf)[:, None, None] * k_int
    cu = dt * flux / (rho_b[:-1] * dz[:-1])[:, None, None]
    cd = dt * flux / (rho_b[1:] * dz[1:])[:, None, None]
    zrow = torch.zeros_like(k_int[:1])
    du = -torch.cat([cu, zrow], dim=0)
    dl = -torch.cat([zrow, cd], dim=0)
    d = 1.0 - du - dl
    return dl, d, du


def diffuse_column(f, dl, d, du):
    """Apply the implicit solve to f: [..., nz, ny, nx] (any leading dims).
    Leading dims become a column batch [nz, L, ny, nx] against [nz, 1, ny,
    nx] coefficients (the kernel reads them by column modulus)."""
    if f.dim() == 3:
        return tridiag_solve(dl, d, du, f)
    lead = f.shape[:-3]
    nz, ny, nx = f.shape[-3:]
    f2 = f.reshape(-1, nz, ny, nx).transpose(0, 1).contiguous()
    x = tridiag_solve(dl[:, None], d[:, None], du[:, None], f2)
    return x.transpose(0, 1).reshape(*lead, nz, ny, nx)


def vertical_diffusion_state(dyn, kv_face, grid: Grid, rho_b, dt):
    """Mix u, v, theta', moisture, chem and TKE down each column."""
    dl, d, du = vdiff_coeffs(kv_face, grid, rho_b, dt)
    return dataclasses.replace(
        dyn,
        u=diffuse_column(dyn.u, dl, d, du),
        v=diffuse_column(dyn.v, dl, d, du),
        theta_p=diffuse_column(dyn.theta_p, dl, d, du),
        moist=diffuse_column(dyn.moist, dl, d, du),
        chem=diffuse_column(dyn.chem, dl, d, du),
        tke=diffuse_column(dyn.tke, dl, d, du),
    )
